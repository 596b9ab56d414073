"""match_s.seq: host seconds of the pipeline's match stage per pass, each
ending in a synchronise, averaged over the window's passes."""


def read(run):
    v = [u["spans"]["match"] for u in run.units if "match" in u.get("spans", {})]
    return sum(v) / len(v) if v else None
