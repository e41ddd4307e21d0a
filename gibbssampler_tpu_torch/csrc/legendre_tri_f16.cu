// Triangular Legendre contractions on float16 tables with a float32 batch
// for Hopper (sm_90a): legendre_tri_bf16.cu in its float16 mode (entry
// points legendre_{synth,adj}_{tri,par}_f16 and legendre_tri_f16_info, with
// the arguments of the bfloat16 ones).  That source's header says what the
// kernels compute, their design and what bounds them.
//
// Replaces, for float16 tables under float32 compute (the JAX package's
// table_dtype=float16), the Pallas TPU kernels of
// gibbssampler_tpu/sht/pallas_legendre.py: legendre_synth_tri (:52) and
// legendre_adj_tri (:106).

#define LEGENDRE_TABLE_F16 1
#include "legendre_tri_bf16.cu"
