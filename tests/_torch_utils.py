"""Shared harness of the port's conformance tests (tests only): carry a
reference (JAX) parameter tree into the bridge's numpy form."""
import numpy as np

from repro.core.bsr import BSRMatrix


def jax_tree_to_numpy(tree):
    """Nested dicts of jax arrays / BSRMatrix -> nested dicts of numpy
    arrays, packed leaves as the bridge's dict form."""
    if isinstance(tree, BSRMatrix):
        return {"idx": np.asarray(tree.idx), "vals": np.asarray(tree.vals),
                "scale": np.asarray(tree.scale),
                "zero": np.asarray(tree.zero), "shape": tuple(tree.shape),
                "group_size": tree.group_size, "bits": tree.bits}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the whole slice in both packages: batched prefill + teacher-forced decode
# ---------------------------------------------------------------------------

NUM_PAGES, PAGE = 24, 8


def slice_inputs(vocab, steps):
    """3 slots (one inactive: length 0, sentinel table), right-padded
    prompts, shuffled block tables and ``steps`` teacher-forced tokens."""
    g = np.random.default_rng(1)
    b, s, mp = 3, 16, 4
    lengths = np.array([11, 0, 5], np.int32)
    tokens = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = g.integers(0, vocab, n)
    pages = g.permutation(NUM_PAGES)[:b * mp].reshape(b, mp)
    bt = pages.astype(np.int32)
    bt[1] = NUM_PAGES                                # inactive slot
    feed = g.integers(0, vocab, size=(steps, b)).astype(np.int32)
    return tokens, lengths, bt, feed


def prefill_both(jcfg, jp, tcfg, tp, tokens, lengths, bt, use_pallas=False):
    """Batched prefill in both packages: (ref logits, ref pool, port
    logits, port pool)."""
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jcache = jtf.init_paged_cache(jcfg, NUM_PAGES, PAGE)
    jl, jcache = jtf.prefill(jp, jcache, jnp.asarray(tokens),
                             jnp.asarray(lengths), jnp.asarray(bt), jcfg,
                             use_pallas=use_pallas)
    tcache = ttf.init_paged_cache(tcfg, NUM_PAGES, PAGE, device="cpu")
    tl, _ = ttf.prefill(tp, tcache, torch.from_numpy(tokens),
                        torch.from_numpy(lengths), torch.from_numpy(bt),
                        tcfg)
    return jl, jcache, tl, tcache


def slice_run(jcfg, jp, tcfg, tp, steps=8, use_pallas=False):
    """Prefill and ``steps`` teacher-forced decode steps in both packages
    (the reference on its jnp path, or its Pallas kernels in interpret
    mode with ``use_pallas``). Returns ([(ref logits, port logits)] per
    step as f32 numpy, active-slot mask)."""
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    tokens, lengths, bt, feed = slice_inputs(jcfg.vocab, steps)
    mp = bt.shape[1]
    active = (lengths > 0).astype(np.int32)
    jl, jcache, tl, tcache = prefill_both(jcfg, jp, tcfg, tp, tokens,
                                          lengths, bt, use_pallas)
    out = [(np.asarray(jl, np.float32), tl.float().numpy())]
    pos = lengths.copy()
    for i in range(steps):
        jl, jcache = jtf.decode_step(
            jp, jcache, jnp.asarray(feed[i][:, None]), jnp.asarray(pos),
            jcfg, use_pallas=use_pallas, block_tables=jnp.asarray(bt),
            max_live_pages=mp)
        tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(feed[i][:, None]),
                                torch.from_numpy(pos), tcfg,
                                torch.from_numpy(bt), max_live_pages=mp)
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
        pos = pos + active
    return out, active.astype(bool)


# ---------------------------------------------------------------------------
# greedy engine tokens in both packages
# ---------------------------------------------------------------------------

def engine_prompts(vocab):
    g = np.random.default_rng(5)
    return [g.integers(0, vocab, n).astype(np.int32)
            for n in (5, 12, 3, 9, 7)]


def serve_all(engine, prompts, max_new):
    for p in prompts:
        engine.submit(p, max_new)
    return {r["rid"]: np.asarray(r["tokens"]) for r in
            engine.run()["results"]}


def port_greedy_margins(tcfg, tp, prompt, tokens):
    """Top-2 logit margin of the port at each greedy step of ``tokens``
    after ``prompt``, teacher-forced through prefill and decode steps (the
    engine's own computation, int8 pool included)."""
    import torch
    from repro_torch.models import transformer as ttf
    n_pages = -(-(len(prompt) + len(tokens)) // PAGE)
    cache = ttf.init_paged_cache(tcfg, n_pages, PAGE, device="cpu")
    bt = torch.arange(n_pages, dtype=torch.int32)[None]
    logits, _ = ttf.prefill(tp, cache, torch.from_numpy(prompt)[None],
                            torch.tensor([len(prompt)]), bt, tcfg)
    rows = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        logits, _ = ttf.decode_step(
            tp, cache, torch.tensor([[int(tok)]]),
            torch.tensor([len(prompt) + i], dtype=torch.int32), tcfg, bt)
        rows.append(logits[0, -1])
    top2 = torch.stack(rows).float().topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def reference_margins(jcfg, jp, prompts, ref, max_new):
    """``margins(rid)``: the reference's top-2 logit margins along its
    greedy paths ``ref``, from a full forward. On the MoE families its
    routing batch differs from the engine's, so these only judge a flip,
    they do not replay it."""
    import jax.numpy as jnp
    from repro.models import transformer as jtf
    seqs = [np.concatenate([p, ref[i]]) for i, p in enumerate(prompts)]
    padded = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        padded[i, :len(s)] = s
    logits = np.asarray(jtf.forward(jp, jnp.asarray(padded), jcfg)[0])

    def margins(rid):
        start = len(prompts[rid]) - 1
        rows = np.sort(logits[rid, start:start + max_new], axis=-1)
        return rows[:, -1] - rows[:, -2]
    return margins


def assert_greedy_match(ref, got, prompts, margins, max_new):
    """Tokens equal wherever the step's top-2 margin exceeds 1e-3 (a
    flip at a nearer tie is not a fault, and the paths part there);
    ``margins(rid)`` gives the margins along the reference's path. At
    least half of all steps must be compared."""
    assert sorted(got) == sorted(ref)
    compared = 0
    for rid in range(len(prompts)):
        assert len(got[rid]) == len(ref[rid]) == max_new
        if np.array_equal(got[rid], ref[rid]):
            compared += max_new
            continue
        m = margins(rid)
        for i in range(max_new):
            if got[rid][i] != ref[rid][i]:
                assert m[i] <= 1e-3, (rid, i, m[i])
                break
            compared += 1
    assert compared >= len(prompts) * max_new // 2
