// K2f and K2b in their bfloat16 mode: fused_window.cu compiled with
// TK_BF16 1 (rgcn_gru_layer.cuh says what the mode computes), its launchers
// exported with the suffix _bf16. Replaces the bfloat16 instantiation of
// temp_tpu/ops/fused_window.py:_fwd_kernel and _bwd_kernel.
#define TK_BF16 1
#define window_layer_launch window_layer_launch_bf16
#define window_bwd_gru_launch window_bwd_gru_launch_bf16
#define window_bwd_input_launch window_bwd_input_launch_bf16
#define window_wgrad_launch window_wgrad_launch_bf16
#include "fused_window.cu"
