"""The device's idle share of the window on one card: 1 - calls x (device
ms of one call) / window ms, the device ms from a CUDA-graph replay of the
entry over the pool after the window.  A graph replays with no host
between kernels, so this is a lower bound of the idle share.  None on a
mesh or where no replay was read."""
UNIT = "share"
END_TO_END = False


def read(t):
    ms = t.device_ms.get("call")
    if t.chips != 1 or not ms:
        return None
    return 1.0 - t.calls * ms / (t.window_s * 1e3)
