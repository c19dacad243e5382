"""Port conformance at mistral-nemo-12b's and qwen3-14b's head ratios
(R = 4, with heads x head_dim != d_model, and R = 5) at the reduced
width: the paged plain path, the int8 pool, a tree round and the
contiguous int8 decode against the reference. The cases and their
tolerances: ``tests/_torch_head_ratios.py``."""
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import _torch_head_ratios as cases  # noqa: E402

RATIOS = [4, 5]


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
