"""Port conformance, self-speculative decoding on the ``mla_moe`` family
(DeepSeek-V2, MLA on the latent pool + MoE): the engine at
the default capacity against the reference's speculative engine (GQSA
and dense-W4 targets, chain and tree), dropless against the port's own
non-speculative engine, one chain and one tree round on the pool, the
MoE block over a round's rows, leak-freedom, no host read and the serve
CLI. The cases and their tolerances: ``tests/_torch_spec_moe.py``."""
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import _torch_spec_moe as cases  # noqa: E402

ARCH = "deepseek_v2_236b"


@pytest.mark.parametrize("case", sorted(cases.ENGINE_CASES))
@pytest.mark.parametrize("target", ["gqsa", "w4"])
def test_spec_engine_matches_reference_at_default_capacity(target, case):
    cases.check_engine_matches_reference(ARCH, target, case)


@pytest.mark.parametrize("mode", ["chain", "tree", "adaptive"])
def test_spec_engine_dropless_equals_no_speculation(mode):
    cases.check_dropless_equals_plain(ARCH, mode)


@pytest.mark.parametrize("k", [1, 3])
def test_fanout1_tree_bit_identical_to_chain(k):
    cases.check_fanout1_tree_equals_chain(ARCH, k)


@pytest.mark.parametrize("kind", sorted(cases.ROUND_CASES))
def test_spec_round_matches_reference_on_the_pool(kind):
    cases.check_round_matches_reference(ARCH, kind)


@pytest.mark.parametrize("tree", [False, True])
def test_spec_round_reads_nothing_on_the_host(tree):
    cases.check_round_reads_nothing_on_the_host(ARCH, tree)


@pytest.mark.parametrize("t", [2, 4, 29])
@pytest.mark.parametrize("capacity_factor", [1.25, cases.DROPLESS])
def test_moe_block_over_round_rows_matches_reference(t, capacity_factor):
    cases.check_moe_block_over_block(ARCH, t, capacity_factor)


@pytest.mark.parametrize("mode", [("chain", 3), ("tree", (2,)),
                                  ("tree", (2, 2))])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_leak_free_under_spec_traffic(seed, mode):
    cases.check_leak_free(ARCH, seed, mode)


@pytest.mark.parametrize("flags", [["--spec", "2"],
                                   ["--spec-tree", "2,2"]])
def test_serve_cli_speculates_on_cpu(capsys, flags):
    cases.check_serve_cli(ARCH, flags, lambda: capsys.readouterr().out)
