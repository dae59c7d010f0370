"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; it never falls back from one to the other. `launches` counts the
kernel launches of each wrapper, so a run can show which kernels its main
path went through.
"""

launches = {"letterbox_normalize": 0, "sample_bilinear": 0, "sample_bilinear_backward": 0,
            "area_attention": 0, "area_attention_backward_dq": 0,
            "area_attention_backward_dkv": 0,
            # the bfloat16 variants: K1 writing bfloat16, K2 and K3 in bfloat16
            "letterbox_normalize_bf16": 0, "sample_bilinear_bf16": 0,
            "sample_bilinear_backward_bf16": 0, "area_attention_bf16": 0,
            "area_attention_backward_dq_bf16": 0, "area_attention_backward_dkv_bf16": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0
