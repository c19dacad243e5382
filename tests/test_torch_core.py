"""Port conformance, compression stack: quantization, pruning, BSR packing
and whole-tree compression against the JAX reference on the same numpy
weights. Packing is exact arithmetic on identical inputs (min/max, one
division, round-half-even), so codes, indices and scale/zero must agree
bit for bit, and so must the decompressed dense weights."""
import dataclasses

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import bsr as jbsr  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.core.saliency import group_saliency as jgroup_saliency  # noqa: E402

from repro_torch.bridge import bsr_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import bsr as tbsr  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.core.model_compress import compress_params, pack_linear  # noqa: E402
from repro_torch.core.saliency import group_saliency, magnitude_saliency  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402

from _torch_utils import jax_tree_to_numpy  # noqa: E402


def _w(seed, n, k):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _assert_bsr_equal(jb, tb):
    t = bsr_to_numpy(tb)
    np.testing.assert_array_equal(t["idx"], np.asarray(jb.idx))
    np.testing.assert_array_equal(t["vals"], np.asarray(jb.vals))
    assert _bits_equal(t["scale"], jb.scale)
    assert _bits_equal(t["zero"], jb.zero)
    assert tuple(tb.shape) == tuple(jb.shape)


@pytest.mark.parametrize("bits", [4, 2])
def test_quantize_and_nibbles_match_reference(bits):
    w = _w(0, 16, 64)
    qc = jquant.QuantConfig(bits=bits, group_size=16)
    tq = tquant.QuantConfig(bits=bits, group_size=16)
    js, jz = jquant.group_minmax_params(jnp.asarray(w), qc)
    ts, tz = tquant.group_minmax_params(torch.from_numpy(w), tq)
    assert _bits_equal(ts.numpy(), js) and _bits_equal(tz.numpy(), jz)
    jq = jquant.quantize(jnp.asarray(w), js, jz, qc)
    tqc = tquant.quantize(torch.from_numpy(w), ts, tz, tq)
    np.testing.assert_array_equal(tqc.numpy(), np.asarray(jq))
    assert _bits_equal(tquant.dequantize(tqc, ts, tz, tq).numpy(),
                       jquant.dequantize(jq, js, jz, qc))
    packed = tquant.pack_int4(tqc)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jquant.pack_int4(jq)))
    np.testing.assert_array_equal(tquant.unpack_int4(packed).numpy(),
                                  tqc.numpy())


@pytest.mark.parametrize("k,sparsity", [(256, 0.5), (4096, 0.5),
                                        (11008, 0.5), (128, 0.25),
                                        (64, 0.99)])
def test_groups_kept_per_row_matches_reference(k, sparsity):
    assert tpruning.groups_kept_per_row(
        k, tpruning.PruneConfig(sparsity=sparsity)) == \
        jpruning.groups_kept_per_row(k, jpruning.PruneConfig(
            sparsity=sparsity))


def _tied_grid():
    """Eight rows of 16 groups drawn from four values, so most rows tie."""
    return np.random.default_rng(7).integers(0, 4, (8, 16)).astype(
        np.float32)


@pytest.mark.parametrize("gsal", [[[1, 1, 1, 1]], [[2, 1, 1, 1]],
                                  "grid"])
def test_row_balanced_mask_breaks_ties_as_the_reference(gsal):
    """Tied group saliencies keep the lower group index, as the
    reference's stable descending argsort does: [[1,1,1,1]] keeps {0, 1}
    and [[2,1,1,1]] keeps {0, 1} at sparsity 0.5."""
    gsal = _tied_grid() if gsal == "grid" else np.asarray(gsal, np.float32)
    cfg = dict(sparsity=0.5, group_size=16)
    jm = jpruning.row_balanced_mask(jnp.asarray(gsal),
                                    jpruning.PruneConfig(**cfg))
    tm = tpruning.row_balanced_mask(torch.from_numpy(gsal),
                                    tpruning.PruneConfig(**cfg))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if gsal.shape[0] == 1:
        assert tm[0, :2].all() and not tm[0, 2:].any()


@pytest.mark.parametrize("n,k,g,sparsity", [(64, 128, 16, 0.5),
                                            (96, 256, 16, 0.25),
                                            (32, 512, 32, 0.5)])
def test_pack_dense_matches_reference(n, k, g, sparsity):
    w = _w(1, n, k)
    jgm = jpruning.group_mask(jgroup_saliency(jnp.square(jnp.asarray(w)), g),
                              jpruning.PruneConfig(sparsity=sparsity,
                                                   group_size=g))
    jb = jbsr.pack_dense(jnp.asarray(w), jgm,
                         jquant.QuantConfig(bits=4, group_size=g))
    tw = torch.from_numpy(w)
    tgm = tpruning.group_mask(group_saliency(magnitude_saliency(tw), g),
                              tpruning.PruneConfig(sparsity=sparsity,
                                                   group_size=g))
    np.testing.assert_array_equal(tgm.numpy(), np.asarray(jgm))
    tb = tbsr.pack_dense(tw, tgm, tquant.QuantConfig(bits=4, group_size=g))
    _assert_bsr_equal(jb, tb)
    assert _bits_equal(tbsr.to_dense(tb).numpy(), jbsr.to_dense(jb))


def test_pack_dense_ragged_mask_matches_reference():
    """Unequal kept groups per row: -1 padding, zero scale/zero/codes."""
    w = _w(2, 24, 128)
    gm = np.random.default_rng(3).random((24, 8)) < 0.4
    gm[5] = False                                   # an empty row
    jb = jbsr.pack_dense(jnp.asarray(w), jnp.asarray(gm),
                         jquant.QuantConfig(bits=4, group_size=16))
    tb = tbsr.pack_dense(torch.from_numpy(w), torch.from_numpy(gm),
                         tquant.QuantConfig(bits=4, group_size=16))
    assert (tb.idx.numpy() < 0).any()
    _assert_bsr_equal(jb, tb)
    assert _bits_equal(tbsr.to_dense(tb).numpy(), jbsr.to_dense(jb))
    for a, b in zip(tbsr.to_paper_bsr(tb), jbsr.to_paper_bsr(jb)):
        np.testing.assert_array_equal(a, b)
    for bn, bm in [(8, 2), (16, 4)]:
        tw, jw = tbsr.build_work_list(tb.idx, bn, bm), \
            jbsr.build_work_list(jb.idx, bn, bm)
        assert tw.n_items == jw.n_items
        for f in ("row_block", "chunk", "first"):
            np.testing.assert_array_equal(getattr(tw, f),
                                          np.asarray(getattr(jw, f)))


def test_compress_params_stacked_matches_reference():
    """JAX init at the reduced llama2-7b config, packed by both packages
    from the same FP tree: every stacked BSR leaf identical."""
    jcfg = jget_config("llama2_7b", reduced=True)
    from repro.models.transformer import init_params as jinit
    jfp = jinit(jax.random.PRNGKey(0), jcfg)
    jpk = jcompress(jfp, jcfg, JGQSAConfig(saliency="magnitude"))
    tfp = params_from_numpy(jax_tree_to_numpy(jfp), "cpu")
    tpk = compress_params(tfp, get_config("llama2_7b", reduced=True),
                          GQSAConfig())
    for blk, names in [("attn", "wq wk wv wo"), ("mlp", "wg wu wd")]:
        for name in names.split():
            _assert_bsr_equal(jpk["layers"][blk][name]["bsr"],
                              tpk["layers"][blk][name]["bsr"])
    assert torch.equal(tpk["lm_head"]["w"], tfp["lm_head"]["w"])


def test_init_params_packs_layer_by_layer():
    """init with ``gqsa`` (pack each layer as it is drawn) equals packing
    the whole FP tree afterwards."""
    cfg = dataclasses.replace(get_config("llama2_7b", reduced=True),
                              n_layers=3)
    fp = init_params(7, cfg, "cpu")
    a = compress_params(fp, cfg, GQSAConfig())
    b = init_params(7, cfg, "cpu", compress=GQSAConfig())
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["lm_head"]["w"], b["lm_head"]["w"])
    for blk in ("attn", "mlp"):
        for name, leaf in a["layers"][blk].items():
            x, y = leaf["bsr"], b["layers"][blk][name]["bsr"]
            for f in ("idx", "vals", "scale", "zero"):
                assert torch.equal(getattr(x, f), getattr(y, f))
    one = pack_linear(fp["layers"]["mlp"]["wd"]["w"][1], GQSAConfig())
    assert torch.equal(one.vals, b["layers"]["mlp"]["wd"]["bsr"].vals[1])
