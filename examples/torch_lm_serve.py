"""Serve a small model on the PyTorch/CUDA port with batched requests:
prefill + greedy decode.

    PYTHONPATH=src python examples/torch_lm_serve.py [--arch gemma2-2b]
        [--device cpu]

The port of ``lm_serve.py``: batched prefill, the KV cache, one-token
decode steps (``models.serving.generate``), at the arch's smoke width
with random weights from seed 0. It takes every arch: the dense
gemma2-2b (whose local layers run kernel G once the prompt is longer than
the window), qwen1.5-0.5b, codeqwen1.5-7b and starcoder2-3b, the MoE
grok-1-314b and arctic-480b (whose expert dispatch runs kernel A), the SSM
mamba2-130m and hybrid zamba2-1.2b (whose ``generate`` replays the prompt
through decode steps), the VLM phi-3-vision-4.2b (stub patch embeddings
before each prompt) and the encoder-decoder whisper-base (stub frame
embeddings for its encoder), the stub inputs drawn as the JAX script draws
them, 0.02 times a standard normal. It runs on the CUDA card, and raises
without one unless ``--device cpu`` is given. The weights, the prompts
and the stub inputs come from ``torch.Generator``s seeded 0, 1 and 2, so
they differ from the JAX script's (threefry) draw.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.models import model as M
from repro_torch.models.serving import generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    cfg = get_smoke_config(args.arch)
    params = M.init_params(cfg, 0, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    dtype = getattr(torch, cfg.dtype)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = 0.02 * torch.randn(
            (args.batch, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device=dev, dtype=dtype)
    if cfg.n_enc_layers:
        extras["frame_embeds"] = 0.02 * torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=dev, dtype=dtype)

    t0 = time.time()
    tokens, _ = generate(cfg, params, prompts, args.new_tokens, **extras)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens}")
    print(f"generated in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s batched)")
    for b in range(args.batch):
        print(f"  req {b}: {tokens[b].tolist()}")
    return {"device": str(dev), "arch": cfg.name,
            "shape": tuple(tokens.shape),
            "in_vocab": bool((tokens >= 0).all()
                             and (tokens < cfg.vocab_size).all()),
            "seconds": dt}


if __name__ == "__main__":
    main()
