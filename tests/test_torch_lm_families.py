"""The port's MoE, SSM and hybrid LM paths against the JAX package.

``test_torch_lm.py``'s four model tests (forward, prefill plus three decode
steps, ``serve_lm``'s greedy tokens, ``lm_params_from_jax``'s shape check)
at the reduced configs of olmoe-1b-7b (MoE, top-4 of 8 experts), arctic-480b
(MoE with the dense residual MLP), mamba2-2.7b (the SSD mixer) and
recurrentgemma-2b (rec, rec, local plus two remainder layers), with the MoE
aux loss compared too. Weights are the JAX ``init_params(PRNGKey(0), ...)``
carried over by ``lm_params_from_jax``; float32 on the CPU at atol = rtol =
1e-5, as ``test_torch_lm.py``. The port's MoE runs ``moe_dispatch`` /
``moe_combine`` on the plain versions of ``mp_scatter`` and
``gather_rows`` there, its local attention ``flash_attention``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.convert import lm_params_from_jax  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("olmoe-1b-7b", "arctic-480b", "mamba2-2.7b", "recurrentgemma-2b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, **kw):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **{**TOL, **kw})


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX config, port config, JAX params, the port's copy)."""
    arch = request.param
    jcfg, tcfg = jarchs.REDUCED[arch], tarchs.REDUCED[arch]
    jparams = jinit(jax.random.PRNGKey(0), jlm.lm_param_defs(jcfg))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 "cpu")
    return arch, jcfg, tcfg, jparams, tparams


def test_forward_and_aux_match(model):
    arch, jcfg, tcfg, jparams, tparams = model
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 19))
    ref, _, ref_aux = jlm.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                  jcfg)
    ours, caches, aux = tlm.forward(tparams, _t(tokens), tcfg)
    assert caches is None
    assert ours.shape == (2, 19, tcfg.vocab_pad)
    _close(ours, ref)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, ref_aux)
    # the MoE configs sum a positive aux over their layers; the others have
    # none
    assert (float(aux) > 0) == bool(tcfg.num_experts)


def test_prefill_and_decode_steps_match(model):
    """Prefill, then three decode steps fed the JAX side's greedy tokens;
    the caches (K/V, SSM state, RG-LRU state, conv windows) are written in
    place into the stacked buffers and their lengths follow."""
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
    # the stacked state the steps wrote is the JAX side's
    for ours, ref in zip(tc["groups"], jc["groups"]):
        for name in ours._fields[:-1]:
            _close(getattr(ours, name), getattr(ref, name), err_msg=name)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax_keeps_each_leafs_dtype_at_bf16(arch):
    """In a bf16 model the router, ``a_log``, ``d_skip``, ``dt_bias`` and
    ``lam`` stay float32 (their definitions say so) and every other leaf is
    bf16; each value crosses bitwise."""
    jcfg = jarchs.REDUCED[arch].replace(dtype=jnp.bfloat16)
    tcfg = tarchs.REDUCED[arch].replace(dtype=torch.bfloat16)
    jparams = jinit(jax.random.PRNGKey(1), jlm.lm_param_defs(jcfg))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 "cpu")
    # jax.tree orders dict keys alike on the three trees; a ParamDef and a
    # tensor are leaves to it
    want = [d.dtype for d in jax.tree.leaves(tlm.lm_param_defs(tcfg))]
    got = jax.tree.leaves(tparams)
    ref = jax.tree.leaves(jparams)
    assert [t.dtype for t in got] == want
    assert torch.float32 in want and torch.bfloat16 in want
    for t, r in zip(got, ref):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(r, np.float32))
