"""lm_iter_ms.bal: the window's solve_ba seconds over its LM iterations
(optim/ba.COUNTS["lm_iters"]), in ms."""


def read(run):
    s = sum(u["spans"]["solve"] for u in run.units
            if "solve" in u.get("spans", {}))
    n = sum(u.get("lm_iters", 0) for u in run.units)
    return 1e3 * s / n if n else None
