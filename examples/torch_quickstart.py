"""Quickstart on the PyTorch port: train a reduced-config LM for a few
steps with the deadline monitor, checkpoint it, resume, then serve it.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Without ``--device cpu`` it runs on the CUDA card and raises where there
is none.  The model is the smoke mamba2-370m, where the JAX package's
quickstart takes the smoke Yi-6B: that config's head dim of 16 has no
flash-attention kernel on the card (it takes 32, 64 and 128), and the
smoke mamba2 runs the SSD and norm kernels on the card as on the CPU.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

ARCH = "mamba2-370m"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ["--device", str(resolve_device(args.device))]

    with tempfile.TemporaryDirectory() as ckpt:
        print("=== train 30 steps with a deadline monitor ===")
        train.main([
            "--arch", ARCH, "--smoke", "--steps", "30",
            "--batch", "4", "--seq", "64", "--deadline", "120",
            "--ckpt-dir", ckpt, "--ckpt-every", "10", *dev,
        ])
        print("=== resume from the checkpoint for 10 more ===")
        resumed = train.main([
            "--arch", ARCH, "--smoke", "--steps", "40",
            "--batch", "4", "--seq", "64",
            "--ckpt-dir", ckpt, "--resume", *dev,
        ])
    assert resumed.start_step == 30 and len(resumed.losses) == 10

    print("=== batched serving (prefill + decode) ===")
    serve.main([
        "--arch", ARCH, "--smoke", "--batch", "2",
        "--prompt-len", "16", "--gen", "8", *dev,
    ])
    print("quickstart OK")


if __name__ == "__main__":
    main()
