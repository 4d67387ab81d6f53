"""End-to-end LM training on the PyTorch port with fault tolerance.

Trains a reduced olmo-1b for a few hundred steps on synthetic data with
checkpoint/resume, on the card — kill it mid-run and re-run to watch it
resume.

  PYTHONPATH=src python examples/train_lm_torch.py            # 200 steps
  PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-1.3b --steps 50
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "olmo-1b"] + argv
    if not any(a.startswith("--steps") for a in argv):
        argv += ["--steps", "200", "--batch", "8", "--seq", "128",
                 "--ckpt-dir",
                 os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")]
    return train_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
