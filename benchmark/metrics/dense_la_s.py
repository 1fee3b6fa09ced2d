"""Device seconds of the dense factors and triangular solves in the
traced call: cuSOLVER's batched Cholesky (``potrf_cta_lower_batch``,
``potrfBatch_trsm_lower``, ``potrf_syrk_nc_kernel``,
``potrf_syrk_T16_nc_kernel``, ``potrf_reset_info``, ``potrf_set_info``)
and cuBLAS's triangular solves (``batch_trsm_left_kernel`` and
``batch_trsm_right_kernel`` at the FBM cell's 100 assets;
``trsm_left_kernel`` and ``kernel_trsm_l_mul32`` at a batch of 4), by the
names the profiler gives them on an NVIDIA H100 (PyTorch's CUDA build);
``None`` where the trace holds none of them."""

# parts of the kernels' names; a kernel counts once if any part is in it
KERNELS = ("potrf", "trsm")


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    seconds = sum(v[1] for k, v in trace["kernels"].items()
                  if any(part in k for part in KERNELS))
    return seconds or None
