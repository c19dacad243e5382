"""The port stands alone and serves: it imports with JAX blocked and names
neither JAX nor the reference package; its serve CLI runs on the CPU when
asked and refuses to fall back to the CPU when it was not."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

from repro_torch.configs.registry import get_config
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.engine.resilience import ChaosConfig, ResilienceConfig
from repro_torch.launch import serve
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "src" / "repro_torch").rglob("*.cu")) \
    + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.serve, chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\brepro\."])
def test_port_sources_name_neither_jax_nor_reference(pattern):
    assert len(PORT_FILES) > 20
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in PORT_FILES
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


def test_serve_on_cpu_prints_digest(capsys):
    res = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in res["results"])


@pytest.mark.parametrize("later", [dict(resilience=ResilienceConfig(
                                       deadline_ttft_ms=50.0)),
                                   dict(prefix_cache=True),
                                   dict(prefill_chunk_tokens=4),
                                   dict(resilience=ResilienceConfig(
                                       chaos=ChaosConfig(alloc_fail=0.5)))])
def test_engine_refuses_options_of_later_slices(later):
    cfg = get_config("llama2_7b", reduced=True)
    eng = InferenceEngine(cfg, init_params(0, cfg, "cpu"),
                          EngineConfig(device="cpu", **later))
    eng.submit(np.arange(4, dtype=np.int32), 2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.run()


def test_serve_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1", "--max-new", "2"])
