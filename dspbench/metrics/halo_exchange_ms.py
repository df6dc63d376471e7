"""The sharded call's halo, (t + 1) C complex samples a rank, shifted from
the left neighbour alone (``parallel.collectives.shift_from_left``)
between CUDA events on every rank; rank 0's median, ms.  None off a
mesh."""
UNIT = "ms"
END_TO_END = False


def read(t):
    return t.device_ms.get("halo")
