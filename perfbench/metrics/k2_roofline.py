"""K2, the verify epilogue (kernels/csrc/verify_stats.cu), against its
roofline: its launches' least time over their profiler device time in
the sub-window, in %.  One call is the main kernel (wgmma or tile
route) and the merge of its partials; its rows are the serve step's
slots times its tree rows."""
import functools

from perfbench.roofline import kernel_share

NAMES = ("verify_stats_wgmma", "verify_stats_tile", "verify_stats_merge")


def read(run):
    main = "verify_stats_tile" if run.profile and \
        "verify_stats_tile" in run.profile["ops"] else "verify_stats_wgmma"
    return kernel_share(run, NAMES, main,
                        functools.partial(run.family.k2_cost, run.cfg))
