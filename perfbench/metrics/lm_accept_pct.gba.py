"""lm_accept_pct.gba: the LM candidates the window's solves accepted
(optim/ba.COUNTS["lm_accepts"]) over their LM iterations, in %: a healthy
solve accepts most of its steps, a stalled one rejects step after step.
None where the program does not count its accepted candidates."""


def read(run):
    units = [u for u in run.units if "lm_accepts" in u]
    n = sum(u["lm_iters"] for u in units)
    if not units or not n:
        return None
    return 100.0 * sum(u["lm_accepts"] for u in units) / n
