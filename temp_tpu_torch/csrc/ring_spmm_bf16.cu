// K13 and K13b in their bfloat16 mode: ring_spmm.cu compiled with
// TK_BF16 1 (ring_spmm.cu says what the mode computes), its launchers
// exported with the suffix _bf16. Replaces the bfloat16 instantiation of
// temp_tpu/parallel/ring_pallas.py:_ring_kernel and of its backward
// _ring_spmm_bwd.
#define TK_BF16 1
#define ring_fwd_step_launch ring_fwd_step_launch_bf16
#define ring_bwd_step_launch ring_bwd_step_launch_bf16
#define ring_dw_launch ring_dw_launch_bf16
#include "ring_spmm.cu"
