"""K3, the fused qkv + RoPE + cache write (kernels/csrc/
fused_qkv_rope_commit.cu), against its roofline: its launches' least
time (one a layer and serve step, over the step's slots times tree
rows) over their profiler device time in the sub-window, in %."""
import functools

from perfbench.roofline import kernel_share

NAMES = ("qkv_wgmma_kernel", "fused_qkv_kernel")


def read(run):
    if not hasattr(run.family, "k3_cost"):
        return None
    main = "fused_qkv_kernel" if run.profile and \
        "fused_qkv_kernel" in run.profile["ops"] else "qkv_wgmma_kernel"
    return kernel_share(run, NAMES, main,
                        functools.partial(run.family.k3_cost, run.cfg))
