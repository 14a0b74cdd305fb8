"""The port stands alone: importing every module of passion_tpu_torch
pulls in neither jax, flax, optax nor the JAX package, chip_smoke.py
imports none of them, and asking for `cuda` without a card raises instead
of falling back to the CPU. The import check runs in a subprocess because
this test process (tests/conftest.py) has jax loaded already."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "passion_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import passion_tpu_torch
names = [m.name for m in pkgutil.walk_packages(passion_tpu_torch.__path__,
                                               "passion_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert "passion_tpu_torch.eval" in probe["imported"]
    assert "passion_tpu_torch.train" in probe["imported"]
    assert "passion_tpu_torch.ops.fused_norm" in probe["imported"]
    for name in ("parallel.world", "losses_legacy", "data.samplers",
                 "interop.torch_weights", "data.preprocess"):
        assert f"passion_tpu_torch.{name}" in probe["imported"]
    assert [m for m in probe["modules"] if _forbidden(m)] == []
    assert "yaml" not in probe["modules"]  # the card's machine has none


def test_name_prefix_rule():
    """passion_tpu_torch starts with passion_tpu: only the JAX package and
    its submodules count as forbidden."""
    assert _forbidden("passion_tpu") and _forbidden("passion_tpu.models")
    assert not _forbidden("passion_tpu_torch")
    assert not _forbidden("jaxtyping")


PORT_SOURCES = ["chip_smoke.py"] + sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "passion_tpu_torch", "**", "*.py"),
        recursive=True))


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_sources_import_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]
    if not path.endswith("__init__.py"):
        assert names  # the walk found the file's imports


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Outside a checkout, and here without CUDA, the smoke test prints no
    result and exits non-zero."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((tmp_path, alone),
                        (REPO, os.path.join(REPO, "chip_smoke.py"))):
        if script != alone and torch.cuda.is_available():
            continue
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from passion_tpu_torch import resolve_device
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.models import get_model

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    model = get_model("mmformer", patch_size=16, basic_dims=4, trans_dim=32,
                      mlp_dim=64, heads=4)
    with pytest.raises(RuntimeError, match="cuda"):
        SlidingWindowSweep(model, 4, 16)  # device defaults to cuda
    assert resolve_device("cpu").type == "cpu"


def test_masks_match_jax():
    from passion_tpu import masks as jm
    from passion_tpu_torch import masks as tm

    np.testing.assert_array_equal(tm.MASK_ARRAY, jm.MASK_ARRAY)
    assert tm.MASK_NAMES == jm.MASK_NAMES and tm.MODALITIES == jm.MODALITIES
    for row in tm.MASK_ARRAY:
        assert tm.mask_id_of(row) == jm.mask_id_of(row)
    with pytest.raises(ValueError):
        tm.mask_id_of([False] * 4)
