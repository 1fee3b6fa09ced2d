"""Launches of cuSOLVER's batched Cholesky kernels in the traced call
(every kernel whose name holds ``potrf``, as the profiler names them on
an NVIDIA H100: ``potrf_cta_lower_batch``, ``potrfBatch_trsm_lower``,
``potrf_syrk_nc_kernel``, ``potrf_syrk_T16_nc_kernel``,
``potrf_reset_info``, ``potrf_set_info``): the factors every Adam step
makes and the jitter ladder's second tries beside them, so a ladder that
retries shows as more launches; ``None`` where the trace holds none."""

KERNEL = "potrf"


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    launches = sum(v[0] for k, v in trace["kernels"].items() if KERNEL in k)
    return float(launches) if launches else None
