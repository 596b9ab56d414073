"""ba_solve_s: the window's seconds over the solves it completed, each a
pack onto the card, solve_ba(p, opts, ell) and the fetch of its result."""


def read(run):
    n = sum(1 for u in run.units if "solve" in u.get("spans", {}))
    return run.window_s / n if n else None
