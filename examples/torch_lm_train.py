"""Train a reduced LM config on the PyTorch/CUDA port for a few hundred
steps.

    PYTHONPATH=src python examples/torch_lm_train.py [--arch gemma2-2b]
        [--steps 200] [--device cpu] [--ckpt-dir DIR]

The port of ``lm_train.py``: the launcher's loop
(``repro_torch.launch.train``: a checkpoint every K steps, the
deterministic data cursor, restart from the newest checkpoint) on the
smoke-sized variant of a decoder-only arch (the dense gemma2-2b,
qwen1.5-0.5b, codeqwen1.5-7b and starcoder2-3b, the MoE grok-1-314b and
arctic-480b, mamba2-130m and zamba2-1.2b; the VLM and the
encoder-decoder raise naming their ROADMAP items). The checkpoints go to ``--ckpt-dir``, by default
``repro_torch_lm_ckpt`` in the temporary directory, apart from the JAX
script's: the launcher resumes from the newest checkpoint it finds there,
so a finished run in that directory is restored and trains no more steps.
It runs on the CUDA card, and raises without one unless ``--device cpu``
is given. The weights come from a ``torch.Generator`` seeded 0, so they
differ from the JAX script's (threefry) draw.
"""

import argparse
import pathlib
import re
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.launch.train import main as train_main

_STEP_LINE = re.compile(r"^step\s+(\d+) loss (\S+)", re.M)


class _Tee:
    """Writes to ``stream`` and keeps a copy of what was written."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_lm_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        train_main(["--arch", args.arch, "--smoke", "--steps",
                    str(args.steps), "--batch", "8", "--seq", "64",
                    "--ckpt-dir", args.ckpt_dir, "--log-every", "20",
                    "--device", str(dev)])
    finally:
        sys.stdout = tee.stream
    losses = {int(s): float(v)
              for s, v in _STEP_LINE.findall("".join(tee.parts))}
    steps = sorted(losses)
    return {"device": str(dev), "arch": args.arch, "losses": losses,
            "loss_falls": (len(steps) > 1
                           and losses[steps[-1]] < losses[steps[0]])}


if __name__ == "__main__":
    main()
