"""The port's step timing probe (``diagnostics.step_phase_times``) on stub
schemes whose CR and C_ell steps take set times on a stand-in clock: the
C_ell step is timed in calls of its own, so that host noise on the CR
calls cannot zero it, and the scheme is left as it was."""

import types

import pytest
import torch

from gibbssampler_tpu_torch.diagnostics import timing
from gibbssampler_tpu_torch.schemes import GibbsState, JointState

CR_S, CLS_S, NOISE_S = 13e-3, 2e-3, 3e-3


class Clock:
    """A clock that only the stub steps move."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class StubScheme:
    """A CR step of CR_S seconds (NOISE_S more when the probe calls it
    alone: a host stall on every lone CR call) and a C_ell step of CLS_S
    seconds on ``clock``; ``joint``: the joint scheme's ``_cr`` (a class
    method) on a state with ``cl``, else an instance ``_cr_step``."""

    def __init__(self, clock, joint):
        self.clock, self.joint, self.inside = clock, joint, False
        self.calls = {"cr": 0, "cls": 0}
        if not joint:
            self._cr_step = self._cr_impl

    def _cr_impl(self, *args, gen=None, **kw):
        self.calls["cr"] += 1
        self.clock.t += CR_S + (0.0 if self.inside else NOISE_S)
        return args[0] + 1.0, types.SimpleNamespace(accept=None)

    def _cr(self, cl, noise=None, gen=None):
        return self._cr_impl(cl, gen=gen)

    def var_cls(self, dl):
        return dl[0]

    def step(self, state, gen=None):
        self.inside = True
        try:
            if self.joint:
                s, _ = self._cr(state.cl, gen=gen)
            else:
                s, _ = self._cr_step(state.s, self.var_cls(state.dl),
                                     gen=gen)
        finally:
            self.inside = False
        self.calls["cls"] += 1
        self.clock.t += CLS_S
        new = (JointState(s=s, cl=state.cl) if self.joint
               else GibbsState(s=s, dl=state.dl))
        return new, {}


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("reps", [1, 3])
def test_cls_is_timed_alone(monkeypatch, joint, reps):
    """cr, cls and full are the least of ``reps`` fenced calls each: cr
    CR_S + NOISE_S, full CR_S + CLS_S and cls exactly CLS_S, where the old
    ``max(full - cr, 0)`` reads 0; one CR draw feeds every cls call; the
    scheme's CR step, the state and the generator are left alone."""
    clock = Clock()
    monkeypatch.setattr(timing, "time",
                        types.SimpleNamespace(perf_counter=clock.perf_counter))
    sch = StubScheme(clock, joint)
    own = dict(vars(sch))
    s = torch.zeros(2, 3)
    state = (JointState(s=s, cl=torch.ones(2, 3)) if joint
             else GibbsState(s=s, dl=(torch.ones(2, 3),)))
    gen = torch.Generator().manual_seed(0)
    g0 = gen.get_state()
    pt = timing.step_phase_times(sch, state, gen, reps=reps)
    assert pt == pytest.approx({"cr": CR_S + NOISE_S, "cls": CLS_S,
                                "full": CR_S + CLS_S}, abs=1e-12)
    assert max(pt["full"] - pt["cr"], 0.0) == 0.0
    # the draw, then a warm call and reps timed calls of cr and full; the
    # C_ell step in every cls and full call
    assert sch.calls == {"cr": 1 + 2 * (1 + reps), "cls": 2 * (1 + reps)}
    assert vars(sch) == own
    assert torch.equal(state.s, torch.zeros(2, 3))
    assert torch.equal(gen.get_state(), g0)
