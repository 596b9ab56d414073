"""frames_per_s: frames fed to every pass of the window over the window's
seconds (the pass running when the time was up is finished and counted)."""


def read(run):
    frames = sum(u.get("frames", 0) for u in run.units)
    return frames / run.window_s if frames else None
