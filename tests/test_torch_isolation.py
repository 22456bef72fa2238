"""``repro_torch`` stands alone: it imports neither ``jax`` nor anything of
the JAX package ``repro``, and its entry points run on the card unless the
caller asks for another device."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core.engine\n"
        "import repro_torch.kernels.pq_adc.ops\n"
        "import repro_torch.kernels.l2dist.ops\n"
        "import repro_torch.kernels.flash_attn.ops\n"
        "import repro_torch.core.perf_model\n"
        "import repro_torch.serve.client, repro_torch.serve.anns_service\n"
        "import repro_torch.serve.tenants, repro_torch.serve.router\n"
        "import repro_torch.serve.stack, repro_torch.serve.autoscaler\n"
        "import repro_torch.serve.edge\n"
        "import repro_torch.core.baselines, repro_torch.core.topk\n"
        "import repro_torch.launch.mesh, repro_torch.sharding.spec\n"
        "import repro_torch.configs.registry, repro_torch.models.layers\n"
        "import repro_torch.models.transformer, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.train, repro_torch.tree\n"
        "import repro_torch.data.synthetic\n"
        "import repro_torch.data.graphs, repro_torch.data.partition\n"
        "import repro_torch.models.recsys, repro_torch.models.gnn\n"
        "import repro_torch.models.api\n"
        "import repro_torch.launch.dryrun\n"
        "import repro_torch.analysis.model_flops\n"
        "import repro_torch.analysis.roofline\n"
        "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
        "assert all(get_config(a) and get_config(a, reduced=True) "
        "for a in ARCH_IDS)\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


def test_no_jax_or_repro_import_anywhere():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno}: {name}")
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.configs.anns_datasets import SIFT_SMALL
    from repro_torch.core import engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((16, 32), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.FusionANNSIndex.build(data, SIFT_SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.FusionANNSIndex.load_snapshot(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ground_truth(data, data[:2], 3)
    assert engine.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No result line without CUDA; none from a directory holding only the
    script either (where CUDA is present it fails on the missing port)."""
    out = subprocess.run([sys.executable, SMOKE], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    if not torch.cuda.is_available():
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrappers_use_plain_versions_only_for_cpu_tensors():
    """On the CPU the wrappers return their plain versions' results and
    launch nothing."""
    from repro_torch.kernels.pq_adc import ops, ref
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 256, (50, 8)).astype(np.uint8))
    luts = torch.from_numpy(rng.random((2, 8, 256)).astype(np.float32))
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.pq_adc_batch(codes, luts),
                       ref.pq_adc_batch_ref(codes, luts))
    q = torch.from_numpy(rng.random((2, 16)).astype(np.float32))
    cb = torch.from_numpy(rng.random((8, 256, 2)).astype(np.float32))
    rows = torch.tensor([[0, 3, 9, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    for int8 in (False, True):
        got = ops.pq_adc_fused_topk(codes, q, cb, rows, 3, lut_int8=int8)
        want = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, 3,
                                           lut_int8=int8)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES == before
