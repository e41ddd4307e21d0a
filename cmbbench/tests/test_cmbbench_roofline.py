"""The Legendre yardstick: work counted at the least any implementation
needs, keyed on the call; hand-worked cases and shares under 100%."""

import math

import pytest

from cmbbench import roofline as rf

L = 513
TRI = L * (L + 1) // 2


@pytest.mark.parametrize("nr", [65, 193, 391, 513])
@pytest.mark.parametrize("C", [256, 1024])
@pytest.mark.parametrize("kind", ["synth", "adj"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_work_by_hand(nr, C, kind, symmetric):
    flops, nbytes = rf.call_work(kind, L, nr, C, "float32", "float32",
                                 symmetric)
    nt = (nr + 1) // 2 if symmetric else nr
    assert flops == 2 * TRI * nt * C
    table = TRI * nt * 4
    if kind == "synth":
        assert nbytes == table + TRI * C * 4 + L * nr * C * 4
    else:
        assert nbytes == table + nr * L * C * 4 + L * L * C * 4


def test_bounds_of_the_kernel_table():
    # the dense counts give PERF.md's bound column (L 513, nr 65, C 256)
    assert math.isclose(1e3 * rf.least_time("synth", L, 65, 256, "float32",
                                            "float32", False), 0.0607,
                        abs_tol=5e-5)
    assert math.isclose(1e3 * rf.least_time("adj", L, 65, 256, "float32",
                                            "float32", False), 0.1009,
                        abs_tol=5e-5)
    assert math.isclose(1e3 * rf.least_time("synth", L, 513, 256, "float32",
                                            "float32", False), 0.2099,
                        abs_tol=5e-5)


# kernel times measured on the card (PERF.md, PR 12 and PR 18 columns):
# (kind, nr, C, ms) of the dense kernels and the parity kernels
MEASURED = [("synth", 65, 256, 0.1357), ("adj", 65, 256, 0.2582),
            ("synth", 193, 256, 0.3771), ("adj", 193, 256, 0.4458),
            ("synth", 391, 256, 0.6735), ("adj", 391, 256, 0.7360),
            ("synth", 513, 256, 0.5465), ("adj", 513, 256, 0.7397),
            ("synth", 513, 512, 1.0762), ("adj", 513, 512, 1.4619)]


@pytest.mark.parametrize("kind,nr,C,ms", MEASURED)
@pytest.mark.parametrize("symmetric", [False, True])
def test_no_share_over_100(kind, nr, C, ms, symmetric):
    t = rf.least_time(kind, L, nr, C, "float32", "float32", symmetric)
    assert 0 < t / (ms * 1e-3) < 1.0


def test_peaks_keyed_on_dtype_pair():
    assert rf.peak_flops("float32", "float32") == 495e12 / 3
    assert rf.peak_flops("float64", "float64") == 67e12
    assert rf.peak_flops("float64", "float32") == 67e12
    assert rf.peak_flops("bfloat16", "float64") == 67e12
    assert rf.peak_flops("bfloat16", "float32") == 989e12
    assert rf.peak_flops("float16", "float32") == 989e12


@pytest.mark.parametrize("name,hit", [
    ("void synth_tri_3xtf32<1>(float const*)", True),
    ("adj_par_bf16", True), ("synth_par_wide", True), ("adj_narrow", True),
    ("_Z16synth_tri_f64PKd", True),
    ("void at::native::elementwise_kernel<128, 2>", False),
    ("Memcpy HtoD (Pageable -> Device)", False)])
def test_kernel_names(name, hit):
    assert bool(rf.LEGENDRE_KERNEL.search(name)) == hit
