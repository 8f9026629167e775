// K3, K4 and K5 in their bfloat16 mode: fused_final.cu compiled with
// TK_BF16 1 (fused_final.cu and rgcn_gru_layer.cuh say what the mode
// computes), its launchers exported with the suffix _bf16. Replaces the
// bfloat16 instantiation of temp_tpu/ops/fused_final.py:_fwd_kernel,
// _bwd_loss_kernel and _bwd_layer_kernel.
#define TK_BF16 1
#define final_layer_launch final_layer_launch_bf16
#define final_scores_launch final_scores_launch_bf16
#define final_loss_reduce_launch final_loss_reduce_launch_bf16
#define final_dq_launch final_dq_launch_bf16
#define final_dq_finish_launch final_dq_finish_launch_bf16
#define final_dtable_launch final_dtable_launch_bf16
#define final_bwd_gru_launch final_bwd_gru_launch_bf16
#define final_bwd_input_launch final_bwd_input_launch_bf16
#define final_wgrad_launch final_wgrad_launch_bf16
#include "fused_final.cu"
