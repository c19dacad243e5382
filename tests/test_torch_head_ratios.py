"""Port conformance at yi-34b's and starcoder2-3b's head ratios (R = 7
and 12 query rows a KV head) at the reduced width: the paged plain path,
the int8 pool, a tree round and the contiguous int8 decode against the
reference, and ``kv_decode_attention_ref`` at R in {12, 16}. The cases
and their tolerances: ``tests/_torch_head_ratios.py``."""
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import _torch_head_ratios as cases  # noqa: E402

RATIOS = [7, 12]


def test_ratios_are_the_full_configs():
    cases.check_ratios_are_the_full_configs()


def test_kv_decode_plan_at_many_query_rows():
    """The card kernel's plan past 8 query rows a KV head, from shapes and
    the SM count alone: starcoder2-3b's (KH 2, R 12) at 4 x 32768 and
    4096; the 16-row limit at 8 KV heads, which fits a block only at 2
    stages; and a block that would not fit even at 2 stages (D = 256, not
    a head dim the kernel takes) halves its heads, unless they were
    given."""
    from repro_torch.kernels import kv_decode_attention as kvd
    assert kvd.MAX_ROWS == 16
    assert kvd.plan(4, 2, 32768, 12, 128, 132) == kvd.Plan(2, 3, 198, 70144)
    assert kvd.plan(4, 2, 4096, 12, 128, 132) == kvd.Plan(2, 3, 128, 70144)
    assert kvd.plan(4, 8, 32768, 16, 128, 132) == kvd.Plan(8, 2, 66,
                                                           219136)
    assert kvd.smem_bytes(8, 16, 128, 3) > kvd.SMEM_LIMIT
    assert kvd.plan(4, 8, 4096, 7, 128, 132).stages == 2
    assert kvd.plan(4, 8, 4096, 4, 128, 132).stages == 3
    p = kvd.plan(4, 8, 4096, 16, 256, 132)
    assert (p.heads, p.stages) == (4, 2) and p.smem <= kvd.SMEM_LIMIT
    assert kvd.plan(4, 8, 4096, 16, 256, 132, heads=8).smem \
        > kvd.SMEM_LIMIT


@pytest.mark.parametrize("r", RATIOS)
def test_paged_plain_path_matches_reference(r):
    cases.check_paged_plain_path(r)


@pytest.mark.parametrize("r", RATIOS)
def test_int8_pool_matches_reference_kernel_path(r):
    cases.check_int8_pool(r)


@pytest.mark.parametrize("r", RATIOS)
def test_tree_round_matches_reference_on_the_pool(r):
    cases.check_tree_round(r)


@pytest.mark.parametrize("r", RATIOS)
def test_contiguous_int8_decode_matches_reference_kernel_path(r):
    cases.check_contiguous_int8_decode(r)


@pytest.mark.parametrize("kh,r", [(1, 12), (2, 16)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_decode_attention_ref_at_many_rows(kh, r, per_slot):
    cases.check_kv_decode_attention_ref(kh, r, per_slot)
