"""extract_s.seq: host seconds of the pipeline's extract stage per pass, each
ending in a synchronise, averaged over the window's passes."""


def read(run):
    v = [u["spans"]["extract"] for u in run.units if "extract" in u.get("spans", {})]
    return sum(v) / len(v) if v else None
