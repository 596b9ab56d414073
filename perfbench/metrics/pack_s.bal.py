"""pack_s.bal: host seconds of pack_camera_major (host numpy and one copy
onto the card, synchronised) per solve, averaged over the window."""


def read(run):
    v = [u["spans"]["pack"] for u in run.units if "pack" in u.get("spans", {})]
    return sum(v) / len(v) if v else None
