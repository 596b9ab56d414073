"""reconstruct_s.seq: host seconds of the pipeline's reconstruct stage per pass, each
ending in a synchronise, averaged over the window's passes."""


def read(run):
    v = [u["spans"]["reconstruct"] for u in run.units if "reconstruct" in u.get("spans", {})]
    return sum(v) / len(v) if v else None
