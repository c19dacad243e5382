"""Port conformance, the architecture registry: ``get_config`` under
underscore and dash names, ``list_archs``, ``supported_shapes`` and
``input_specs`` against the JAX reference's for every arch the port
registers, and the port's init of the dense configs with packing as
drawn (qwen3-14b's ``qk_norm``, starcoder2-3b's GELU MLP) against packing
the whole FP tree afterwards. All exact: these are shapes, names and
the same arithmetic on the same numbers."""
import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.bsr import BSRMatrix  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.core.model_compress import compress_params  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DENSE = ["yi_34b", "starcoder2_3b", "qwen3_14b", "mistral_nemo_12b"]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("reduced", [False, True])
def test_get_config_takes_both_names_and_equals_reference(arch, reduced):
    """Field for field the reference's config (dtypes by name), under the
    underscore id and the dash alias."""
    want = dataclasses.asdict(jreg.get_config(arch, reduced))
    for name in (arch, arch.replace("_", "-")):
        assert dataclasses.asdict(treg.get_config(name, reduced)) == want


def test_get_config_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="A.7.3, A.8"):
        treg.get_config("mamba2_130m")


@pytest.mark.parametrize("include_extra", [False, True])
def test_list_archs_is_the_reference_order_of_the_ported(include_extra):
    want = [a for a in jreg.list_archs(include_extra)
            if a in treg.ARCH_IDS]
    assert treg.list_archs(include_extra) == want
    assert set(treg.list_archs(True)) == set(treg.ARCH_IDS)
    assert ("llama2_7b" in treg.list_archs(include_extra)) == include_extra


def test_shapes_table_equals_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", sorted(treg.ARCH_IDS))
def test_supported_shapes_and_input_specs_equal_reference(arch):
    """Every shape cell: the supported list, and each input spec's keys,
    shape and dtype (``meta`` tensors here, ``ShapeDtypeStruct`` there)."""
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert treg.supported_shapes(cfg) == jreg.supported_shapes(jcfg)
    for name, shape in SHAPES.items():
        got = treg.input_specs(cfg, shape)
        want = jreg.input_specs(jcfg, JSHAPES[name])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("family,n_patches", [("vlm", 576), ("encdec", 0)])
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_of_the_other_families_equal_reference(family, n_patches,
                                                          kind):
    """The vlm and encdec branches are shapes only: the same specs on a
    config of that family (its registry entry is a later slice)."""
    cfg = dataclasses.replace(treg.get_config("llama2_7b"), family=family,
                              n_patches=n_patches)
    jcfg = dataclasses.replace(jreg.get_config("llama2_7b"), family=family,
                               n_patches=n_patches)
    got = treg.input_specs(cfg, SHAPES[kind])
    want = jreg.input_specs(jcfg, JSHAPES[kind])
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in got.items()} == \
        {k: (tuple(t.shape), str(t.dtype)) for k, t in want.items()}


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, BSRMatrix):
        assert isinstance(b, BSRMatrix) and a.shape == b.shape
        for f in ("idx", "vals", "scale", "zero"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3_14b", "starcoder2_3b"])
def test_init_packs_as_drawn_equals_packing_afterwards(arch):
    """init with GQSA (each layer packed as it is drawn) equals
    ``compress_params`` of the FP init: every leaf, the q/k norms of
    qwen3-14b and starcoder2-3b's MLP without ``wg`` included."""
    cfg = treg.get_config(arch, reduced=True)
    fp = ttf.init_params(3, cfg, "cpu")
    a = compress_params(fp, cfg, GQSAConfig())
    b = ttf.init_params(3, cfg, "cpu", compress=GQSAConfig())
    _assert_trees_equal(a, b)
    assert ("q_norm" in b["layers"]["attn"]) == cfg.qk_norm
    assert ("wg" in b["layers"]["mlp"]) == (cfg.mlp_type == "swiglu")
