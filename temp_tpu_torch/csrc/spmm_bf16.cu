// K1f and K1b in their bfloat16 mode: spmm.cu compiled with TK_BF16 1
// (spmm.cu says what the mode computes), its launchers exported with the
// suffix _bf16. Replaces the bfloat16 instantiation of
// temp_tpu/ops/pallas_spmm.py:_fwd_kernel and _bwd_kernel.
#define TK_BF16 1
#define spmm_fwd_launch spmm_fwd_launch_bf16
#define spmm_bwd_launch spmm_bwd_launch_bf16
#include "spmm.cu"
