"""pcg_iters_per_lm.bal: PCG iterations per LM iteration over the window
(optim/ba.COUNTS["cg_iters"] / COUNTS["lm_iters"])."""


def read(run):
    n = sum(u.get("lm_iters", 0) for u in run.units)
    if not n:
        return None
    return sum(u.get("cg_iters", 0) for u in run.units) / n
