"""The whole window's share of the card's roofline, in %: over every
serve step and prefill call begun inside the window, the least time the
work could take (the larger of its operations at the bf16 peak and its
bytes at the HBM peak, counted from the configuration's widths, the
active slots' tree rows and committed rows, and the prompt tokens), the
sum over the window's wall time."""
from perfbench.roofline import bound_s, peaks


def read(run):
    pk = peaks(run.device_kind)
    if pk is None or run.window_s <= 0:
        return None
    fam, cfg = run.family, run.cfg
    least = sum(bound_s(*fam.step_cost(cfg, run.tree_rows, ctx), pk)
                for t, ctx in run.steps if run.in_window(t))
    least += sum(bound_s(*fam.prefill_cost(cfg, group), pk)
                 for t, groups in run.prefills if run.in_window(t)
                 for group in groups)
    return 100.0 * least / run.window_s
