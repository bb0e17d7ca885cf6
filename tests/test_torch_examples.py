"""The port's examples (``examples/torch_*.py``) on the CPU.

Each script's ``main(argv)`` runs in process with ``--device cpu`` at a
reduced size, where the ``"cuda"`` backend's wrappers run their kernels'
plain versions; its returned checks must hold (the scripts' own asserts
run too). Without ``--device`` each raises where no card is visible, and
none imports JAX or the JAX package.
"""

import ast
import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch.ckpt import checkpoint as C

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "md_lennard_jones", "sph_demo", "distributed_md",
            "serve_engine", "autotune_batch", "lm_serve", "lm_train"]


def _load(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_port_example_is_listed():
    assert sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py")) \
        == sorted(f"torch_{n}" for n in EXAMPLES)
    # each JAX script has its port
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                  if not p.stem.startswith("torch_")) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples" / f"torch_{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    argv = ["--ckpt-dir", str(tmp_path)] if name == "lm_train" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)


def test_quickstart_every_backend_agrees_with_the_oracle():
    out = _load("quickstart").main(["--division", "4", "--n", "400",
                                    "--device", "cpu"])
    assert set(out["rel_err"]) == {
        "cuda/allin", "cuda/cell_dense/sfc", "cuda/xpencil",
        "reference/allin", "reference/cell_dense", "reference/par_part",
        "reference/xpencil"}
    assert max(out["rel_err"].values()) <= 3e-4 and not out["replanned"]


def test_md_lennard_jones_conserves_energy():
    out = _load("md_lennard_jones").main(
        ["--steps", "20", "--division", "4", "--ppc", "3", "--device",
         "cpu"])
    assert out["finite"] and out["drift"] < 0.05


def test_sph_demo_stays_finite():
    out = _load("sph_demo").main(["--division", "4", "--n", "600",
                                  "--steps", "6", "--device", "cpu"])
    assert out["finite"] and 0.0 < out["rho_mean"] <= out["rho_max"]


def test_distributed_md_matches_the_one_device_plan():
    out = _load("distributed_md").main(["--division", "4", "--n", "500",
                                        "--device", "cpu"])
    assert out["n_shards"] == 4 and out["compact_bit_equal"]
    assert out["max_abs_err"] <= 3e-4 * max(out["force_scale"], 1.0)
    assert out["grown_shard_cap"] > 8


def test_serve_engine_steady_state_builds_nothing():
    out = _load("serve_engine").main(["--requests", "12", "--device", "cpu"])
    assert out["ok"] == out["requests"] == 12
    assert out["steady_state_recompiles"] == 0 and out["batches"] >= 1


def test_autotune_batch_caches_and_batches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    out = _load("autotune_batch").main(
        ["--n", "200", "--systems", "3", "--n-per-system", "100",
         "--device", "cpu"])
    assert pathlib.Path(out["cache_file"]).parent == tmp_path
    assert out["timed"] > 0 and out["cached_timing_runs"] == 0
    assert (out["batch_dispatches"], out["loop_dispatches"]) == (1, 3)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b", "grok-1-314b",
                                  "arctic-480b", "mamba2-130m",
                                  "zamba2-1.2b"])
def test_lm_serve_generates_in_vocab(arch):
    out = _load("lm_serve").main(["--arch", arch, "--new-tokens", "6",
                                  "--device", "cpu"])
    assert out["shape"] == (4, 6) and out["in_vocab"]


def test_lm_serve_unported_family_raises_naming_the_item():
    with pytest.raises(ValueError, match=r"Queue 1 item 13\.4"):
        _load("lm_serve").main(["--arch", "whisper-base", "--device", "cpu"])


def test_lm_train_loss_falls_and_resumes(tmp_path):
    mod = _load("lm_train")
    argv = ["--steps", "40", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = mod.main(argv)
    assert sorted(out["losses"]) == [0, 20, 39] and out["loss_falls"]
    assert C.latest_step(tmp_path) == 40
    # a finished run in the directory is restored: no step trains again
    assert mod.main(argv)["losses"] == {}


@pytest.mark.parametrize("arch", ["grok-1-314b", "zamba2-1.2b"])
def test_lm_train_takes_the_moe_and_hybrid_archs(arch, tmp_path):
    """The launcher's loop on a MoE and a hybrid smoke config: 21 steps
    (logged at 0 and 20), finite losses, a checkpoint at the end."""
    out = _load("lm_train").main(["--arch", arch, "--steps", "21",
                                  "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path)])
    assert sorted(out["losses"]) == [0, 20] and out["arch"] == arch
    assert all(math.isfinite(v) for v in out["losses"].values())
    assert C.latest_step(tmp_path) == 21
