// K6+K7 and K9+K10 in their bfloat16 mode: fused_final_bi.cu compiled with
// TK_BF16 1 (fused_final_bi.cu and rgcn_gru_layer.cuh say what the mode
// computes), its launchers exported with the suffix _bf16. Replaces the
// bfloat16 instantiation of temp_tpu/ops/fused_final_bi.py:
// _conv_fwd_bi_kernel, _gru_fwd_bi_kernel, _gru_bwd_bi_kernel and
// _conv_bwd_bi_kernel (K8 and K4: fused_final_bf16.cu's launches).
#define TK_BF16 1
#define bi_layer_launch bi_layer_launch_bf16
#define bi_bwd_gru_launch bi_bwd_gru_launch_bf16
#define bi_wgrad_launch bi_wgrad_launch_bf16
#include "fused_final_bi.cu"
