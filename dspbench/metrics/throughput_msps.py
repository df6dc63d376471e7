"""Input samples of all calls completed in the window over the whole
window, in millions a second (host clock)."""
UNIT = "Msamples/s"
END_TO_END = True


def read(t):
    return t.calls * t.samples / t.window_s / 1e6
