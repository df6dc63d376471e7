"""Runs the autotune calibration and prints its report (twin of
``examples/show_calibration.py``, the reference's show_calibration.rs).
The winners are installed and written to the autotune cache
(``BDSP_AUTOTUNE_CACHE``, else ``~/.cache/basic_dsp_tpu_torch/``).

    python3 -m basic_dsp_tpu_torch.examples.show_calibration
"""
import basic_dsp_tpu_torch as bt


def main(device=None) -> dict:
    """Returns the installed entry."""
    best = bt.autotune.calibrate(n=1 << 18,
                                 block_candidates=(512, 1024, 2048, 4096),
                                 iters=2, device=device)
    bt.autotune.print_calibration()
    print(f"calibration installed: {best}")
    return best


if __name__ == "__main__":
    main()
