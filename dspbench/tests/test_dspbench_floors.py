"""The frozen roofline arithmetic against the bounds PERF.md states."""
import math

import pytest

from dspbench import floors

N = 1 << 22


def test_the_calls_floors_are_their_bytes():
    # the capture's planes read once, the result written once
    chain = floors.floor_ms(12.0 * N, (floors.fir_flops(128) + 2
                                       + 5 * math.log2(N) + 3) * N)
    assert chain[1] == "bytes"
    assert chain[0] * 1e3 == pytest.approx(15.02, abs=0.005)
    assert chain[3] * 1e3 == pytest.approx(14.8, abs=0.05)   # 0.99 GFLOP
    chan = floors.floor_ms(12.0 * N, (4 * 8 + 5 * 10 + 6) * N)
    assert chan[1] == "bytes" and chan[0] * 1e3 == pytest.approx(15.02,
                                                                  abs=0.005)


def test_the_kernels_floors():
    # K1: the (128, 32768) planes, its factored and inner twiddles, the
    # (128, 256, 128) magnitudes
    held = 4.0 * (2 * 128 * 256 + 2 * 128 * 128 + 2 * 256 * 128)
    k1 = floors.floor_ms(8.0 * N + held + 4.0 * N, 0.0)
    assert k1[0] * 1e3 == pytest.approx(15.22, abs=0.005)
    # K6: the planes and the (9, 1024) merged taps in, the angles out
    k6 = floors.floor_ms(12.0 * N + 4.0 * 9 * 1024, 0.0)
    assert k6[0] * 1e3 == pytest.approx(15.04, abs=0.005)


def test_fir_flops_takes_the_cheaper_algorithm():
    assert floors.fir_flops(4) == 16.0
    assert floors.fir_flops(128) == pytest.approx(121.0, abs=0.05)
    assert floors.fir_flops(128) < 4 * 128


@pytest.mark.parametrize("nbytes,flops", [(12.0 * N, 1e9), (1e6, 1e12),
                                          (48e6, 0.0)])
def test_no_share_passes_100_for_a_time_at_or_above_the_floor(nbytes,
                                                              flops):
    fl = floors.floor_ms(nbytes, flops)[0]
    assert floors.share_pct(nbytes, flops, fl) == pytest.approx(100.0)
    for t in (fl * 1.0001, fl * 3, fl * 1e4):
        assert floors.share_pct(nbytes, flops, t) < 100.0
    assert floors.share_pct(nbytes, flops, 0.0) is None
