"""The port's dense LM serving path against the JAX package.

The same numpy-seeded inputs go through each JAX module and its port:
the layers (``rmsnorm`` in both forms, ``apply_rope``, gelu, ``softcap``),
both attention paths, and whole models at the reduced configs of
llama3-8b (GQA, RoPE, SwiGLU), gemma2-27b (local/global layers, post
norms, plus-one norms, embedding scale, both softcaps, gelu) and
qwen1.5-0.5b (qkv bias, tied embeddings). Model weights are the JAX
``init_params(PRNGKey(0), ...)`` carried over by ``lm_params_from_jax``.
Everything is float32 on the CPU, held at atol = rtol = 1e-5 (the
reference's own eager-against-jitted tolerance); the port's attention
runs ``flash_attention``'s plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro_torch.checkpoint.convert import lm_params_from_jax  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402
from repro_torch.nn import transformer as ttr  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("llama3-8b", "gemma2-27b", "qwen1.5-0.5b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, **kw):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **{**TOL, **kw})


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches(plus_one):
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 64)).astype(np.float32)
    s = r.normal(size=(64,)).astype(np.float32)
    _close(tlayers.rmsnorm(_t(x), _t(s), 1e-6, plus_one=plus_one),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6,
                           plus_one=plus_one))


def test_rope_gelu_softcap_match():
    """RoPE rotates split halves; gelu is the tanh form; softcap as JAX."""
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = r.integers(0, 4096, size=(2, 7)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 5e5),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5))
    y = (r.normal(size=(3, 50)) * 4).astype(np.float32)
    _close(tlayers.activation("gelu")(_t(y)),
           jlayers.activation("gelu")(jnp.asarray(y)))
    _close(tlayers.activation("silu")(_t(y)),
           jlayers.activation("silu")(jnp.asarray(y)))
    _close(tlayers.softcap(_t(y), 5.0), jlayers.softcap(jnp.asarray(y), 5.0))


@pytest.mark.parametrize("s,window,cap", [
    (64, None, None),
    (37, None, None),            # ragged: not a multiple of the chunks
    (45, 8, 30.0),               # ragged, local window and softcap
])
def test_chunked_attention_matches(s, window, cap):
    """GQA (4 query heads over 2 KV heads) prefill attention."""
    r = np.random.default_rng(s)
    q = r.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, s, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_softcap=cap, q_chunk=16,
              kv_chunk=16)
    _close(tatt.chunked_attention(_t(q), _t(k), _t(v), **kw),
           jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw))


@pytest.mark.parametrize("window,cap", [(None, None), (6, 50.0)])
def test_decode_attention_matches(window, cap):
    r = np.random.default_rng(3)
    q = r.normal(size=(2, 1, 4, 16)).astype(np.float32)
    ck = r.normal(size=(2, 24, 2, 16)).astype(np.float32)
    cv = r.normal(size=(2, 24, 2, 16)).astype(np.float32)
    kw = dict(window=window, logit_softcap=cap)
    _close(tatt.decode_attention(_t(q), _t(ck), _t(cv), 17, **kw),
           jatt.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(17, jnp.int32),
                                 **kw))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX config, port config, JAX params, the port's copy)."""
    arch = request.param
    jcfg, tcfg = jarchs.REDUCED[arch], tarchs.REDUCED[arch]
    jparams = jinit(jax.random.PRNGKey(0), jlm.lm_param_defs(jcfg))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 "cpu")
    return arch, jcfg, tcfg, jparams, tparams


def test_forward_matches(model):
    arch, jcfg, tcfg, jparams, tparams = model
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 19))
    ref, _, _ = jlm.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    ours, caches = tlm.forward(tparams, _t(tokens), tcfg)
    assert caches is None
    assert ours.shape == (2, 19, tcfg.vocab_pad)
    _close(ours, ref)


def test_prefill_and_decode_steps_match(model):
    """Prefill, then three decode steps fed the JAX side's greedy tokens;
    the caches' lengths follow."""
    arch, jcfg, tcfg, jparams, tparams = model
    b, s, max_len = 2, 24, 32
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, s))
    jc = jinit(jax.random.PRNGKey(0), jlm.lm_cache_defs(jcfg, b, max_len))
    tc = tlm.init_caches(tcfg, b, max_len, "cpu")
    jl, jc = jlm.prefill(jparams, jnp.asarray(prompt, jnp.int32), jc, jcfg)
    tl, tc = tlm.prefill(tparams, _t(prompt), tc, tcfg)
    _close(tl, jl)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, :jcfg.vocab_size], -1))[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(tok, jnp.int32), jc,
                                 jcfg, position=jnp.asarray(s + i, jnp.int32))
        tl, tc = tlm.decode_step(tparams, _t(tok), tc, tcfg, position=s + i)
        _close(tl, jl, err_msg=f"decode step {i}")
    lengths = [c.length for c in tc["groups"]] + [c.length for c in tc["rem"]]
    assert lengths and set(lengths) == {s + 3}


def test_serve_lm_greedy_tokens_match(model, monkeypatch):
    """``serve_lm`` with the JAX weights gives the JAX greedy tokens."""
    arch, jcfg, tcfg, jparams, tparams = model
    monkeypatch.setattr(tlm, "init_params", lambda gen, cfg, dev: tparams)
    b, s, n = 2, 32, 6
    out = tserve.serve_lm(arch, n, batch=b, prompt_len=s, max_len=40,
                          device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s))
    jc = jinit(jax.random.PRNGKey(0), jlm.lm_cache_defs(jcfg, b, 40))
    logits, jc = jlm.prefill(jparams, jnp.asarray(prompt, jnp.int32), jc,
                             jcfg)
    tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)[:, None]
    want = [tok]
    for i in range(n - 1):
        logits, jc = jlm.decode_step(jparams, tok, jc, jcfg,
                                     position=jnp.asarray(s + i, jnp.int32))
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)[:, None]
        want.append(tok)
    np.testing.assert_array_equal(out["tokens"],
                                  np.asarray(jnp.concatenate(want, 1)))
    assert out["generated"] == (b, n)


def test_lm_params_from_jax_checks_shapes(model):
    arch, jcfg, tcfg, jparams, tparams = model
    tree = jax.tree.map(np.asarray, jparams)
    assert isinstance(tparams["stack"]["groups"], tuple)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_jax(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch,what", [("mamba2-2.7b", "mamba"),
                                       ("recurrentgemma-2b", "rec"),
                                       ("olmoe-1b-7b", "MoE")])
def test_unported_blocks_raise(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        tlm.lm_param_defs(tarchs.REDUCED[arch])
    assert ttr.PATTERNS == {"global": ("attn",),
                            "local_global": ("local", "attn"),
                            "griffin": ("rec", "rec", "local"),
                            "ssm": ("mamba",)}
