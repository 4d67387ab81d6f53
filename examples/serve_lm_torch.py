"""Batched serving on the PyTorch port: prefill + greedy decode with
per-family caches, on the card.

  PYTHONPATH=src python examples/serve_lm_torch.py
  PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-9b
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "h2o-danube-1.8b"] + argv
    if not any(a.startswith("--batch") for a in argv):
        argv += ["--batch", "4", "--prompt-len", "64", "--new-tokens", "32"]
    return serve_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
