"""Port conformance at group sizes 8 and 32: the served paths of
``gqsa_gemv`` and its expert axis at the group sizes the CUDA kernel takes
beside 16. Each reduced model is initialised and GQSA-packed (W4 S50 at
group size g) by the JAX reference and carried over through the bridge;
both packages then run batched prefill and teacher-forced decode steps,
and the serving engine, on the same inputs. The port's CPU path is the
kernels' plain versions; the card's kernels are held against those in
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.

Cases: llama2-7b and deepseek-moe-16b at g = 8 and 32; DeepSeek-V2 at
g = 8 only: its reduced ``q_lora_rank`` of 48 (the K of its ``wq_b``
projection) is not a multiple of 32, while its full-width dims all are.

Tolerances (f32, the reduced configs' compute dtype), as the g = 16
conformance files hold them: logits to 1e-4 abs on llama2-7b
(``test_torch_model.py``), |port - ref| <= 1e-5 x max |ref| on
deepseek-moe-16b (``test_torch_moe_family.py``) and 2e-4 x max |ref| on
DeepSeek-V2 (``test_torch_mla_moe.py``): the same f32 math, summed in
another order. Engine: greedy tokens identical wherever the reference's
top-2 logit margin exceeds 1e-3 (a flip at a nearer tie is not a
fault)."""
import functools
import re

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.core.pruning import PruneConfig as JPruneConfig  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, reference_margins, serve_all,
                          slice_run)

CASES = [("llama2_7b", 8), ("llama2_7b", 32), ("deepseek_moe_16b", 8),
         ("deepseek_moe_16b", 32), ("deepseek_v2_236b", 8)]
# logits bar a step: (absolute, relative to max |ref|)
BARS = {"llama2_7b": (1e-4, 0.0), "deepseek_moe_16b": (0.0, 1e-5),
        "deepseek_v2_236b": (0.0, 2e-4)}


@functools.lru_cache(maxsize=None)
def _packed(arch, g):
    """(jax config, jax params, numpy bridge form) of the reduced ``arch``
    packed by the reference at group size ``g``."""
    jcfg = jget_config(arch, reduced=True)
    gqsa = JGQSAConfig(quant=JQuantConfig(bits=4, group_size=g),
                       prune=JPruneConfig(sparsity=0.5, group_size=g),
                       saliency="magnitude")
    jp = jcompress(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg, gqsa)
    return jcfg, jp, jax_tree_to_numpy(jp)


def _group_sizes(tree):
    """Every packed leaf's group size in a bridge-form tree."""
    if isinstance(tree, dict):
        if "group_size" in tree:
            return {tree["group_size"]}
        return set().union(*(_group_sizes(v) for v in tree.values()))
    return set()


@pytest.mark.parametrize("arch,g", CASES)
def test_prefill_and_decode_logits_match_reference(arch, g):
    """Paged prefill (3 slots, one inactive) and 6 teacher-forced decode
    steps in both packages on the reference's packing at g."""
    jcfg, jp, npp = _packed(arch, g)
    assert _group_sizes(npp) == {g}
    steps, act = slice_run(jcfg, jp, get_config(arch, reduced=True),
                           params_from_numpy(npp, "cpu"), steps=6)
    atol, rel = BARS[arch]
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        bar = atol + rel * np.abs(j[act]).max()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=bar)


@pytest.mark.parametrize("arch,g", CASES)
def test_engine_greedy_tokens_match_reference(arch, g):
    """The serving engines of both packages, 5 requests x 8 greedy tokens
    on 2 slots, on the reference's packing at g."""
    jcfg, jp, npp = _packed(arch, g)
    tcfg = get_config(arch, reduced=True)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(tcfg, params_from_numpy(npp, "cpu"),
                                    EngineConfig(num_slots=2, max_seq=32,
                                                 page_size=PAGE,
                                                 device="cpu")),
                    prompts, max_new)
    assert_greedy_match(ref, got, prompts,
                        reference_margins(jcfg, jp, prompts, ref, max_new),
                        max_new)


def test_serve_cli_serves_group_size_32_on_cpu(capsys):
    """``--compress gqsa --group-size 32`` end to end on the CPU: the port
    packs every projection at g = 32 and serves."""
    res = serve.main(["--device", "cpu", "--reduced", "--compress", "gqsa",
                      "--group-size", "32", "--requests", "3", "--max-new",
                      "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "packed GQSA W4 S50% G32" in out
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in res["results"])


def test_prefill_and_decode_never_read_the_device_on_the_host_at_g8():
    """``tests/test_torch_model.py``'s check at g = 8: neither step reads
    a tensor's value on the host (each read is a host-device sync per
    call); the profiler counts the reads on the CPU as it would on the
    card."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("llama2_7b", reduced=True)
    gqsa = GQSAConfig(quant=QuantConfig(bits=4, group_size=8),
                      prune=PruneConfig(sparsity=0.5, group_size=8))
    params = ttf.init_params(0, cfg, "cpu", compress=gqsa)
    assert params["layers"]["attn"]["wq"]["bsr"].group_size == 8
    cache = ttf.init_paged_cache(cfg, 8, 4, device="cpu")
    bt = torch.tensor([[0, 1, 2], [8, 8, 8]], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 0], [0] * 4]),
                    torch.tensor([3, 0]), bt, cfg)
        ttf.decode_step(params, cache, torch.tensor([[1], [2]]),
                        torch.tensor([3, 0], dtype=torch.int32), cfg, bt,
                        max_live_pages=2)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
