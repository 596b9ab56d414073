"""ba_s.seq: seconds the mapper spent in local and global bundle adjustment
per pass (its MapperStats time_lba + time_gba: host clocks around solves
that end in a fetch), averaged over the window's passes."""


def read(run):
    v = [u["ba_s"] for u in run.units if "ba_s" in u]
    return sum(v) / len(v) if v else None
