"""The port's LM template training path (``repro_torch.models``, ``.data.lm``,
``.train``) against the reference, on the CPU, with the reference's
parameters carried across (``convert.lm_params_from_numpy``).

The smoke configs of qwen3-1.7b (GQA, qk-norm), olmo-1b (non-parametric
LayerNorm, MHA) and mamba2-1.3b (FFN-less Mamba2 layers, the chunked SSD
scan at chunk 32 over a sequence of 64) run in float32 with ``attn_chunk``
lowered below the sequence, so attention takes the query-chunked branch
(the flash kernel's place on the card).  Tolerances, for float32 sums in other orders:
hidden states and loss within 1e-5 relative (2e-5 of max |h| absolute);
gradients, AdamW moments and updated parameters within 1e-4 of each
leaf's max |.|.  ``lm_batch``'s tokens and labels are equal under the
reference's golden key layout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (SHAPES as R_SHAPES, get_config as r_get_config,
                           get_smoke_config as r_smoke, input_specs as r_specs,
                           list_archs)
from repro.data.lm import lm_batch as r_lm_batch
from repro.models import forward_hidden as r_forward_hidden
from repro.models import init_model as r_init_model
from repro.models import lm_loss as r_lm_loss
from repro.models.model import layer_descriptors as r_layer_descriptors
from repro.train.optimizer import OptimizerConfig as ROptConfig
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.steps import make_train_step as r_make_train_step
from repro_torch import random as trandom
from repro_torch.configs import SHAPES, get_config, get_smoke_config, input_specs
from repro_torch.convert import (lm_grads_to_numpy, lm_named_from_tree,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data import lm as tlm
from repro_torch.models.model import (LM, forward_hidden, init_model,
                                      layer_descriptors, lm_loss)
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.steps import make_train_step

from _torch_port import golden_key_layout

ARCHS = ["qwen3-1.7b", "olmo-1b", "mamba2-1.3b"]
SEQ, BATCH, CHUNK = 64, 4, 32


def _cfgs(arch, **kw):
    kw.setdefault("attn_chunk", CHUNK)
    return (dataclasses.replace(r_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _setup(arch, **kw):
    rcfg, tcfg = _cfgs(arch, **kw)
    params, _ = r_init_model(rcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 "cpu")
    batch = r_lm_batch(rcfg, 0, 0, BATCH, SEQ)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return rcfg, tcfg, params, model, batch, tbatch


def _leaves_close(want_tree, got_tree, tol=1e-4):
    assert jax.tree.structure(want_tree) == jax.tree.structure(got_tree)
    for w, g in zip(jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)):
        w = np.asarray(w, np.float32)
        assert w.shape == g.shape
        err = np.abs(w - g).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), err


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list_archs())
def test_configs_and_descriptors_equal(arch):
    for rc, tc in ((r_get_config(arch), get_config(arch)),
                   (r_smoke(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
        assert r_layer_descriptors(rc) == layer_descriptors(tc)
        assert rc.param_count() == tc.param_count()
        assert rc.active_param_count() == tc.active_param_count()
        assert str(tc.activation_dtype) == f"torch.{rc.dtype}"
        for name in R_SHAPES:
            want = {k: (v.shape, str(v.dtype))
                    for k, v in r_specs(rc, R_SHAPES[name]).items()}
            got = {k: (s, str(d).replace("torch.", ""))
                   for k, (s, d) in input_specs(tc, SHAPES[name]).items()}
            assert want == got


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b",
                                  "llama4-maverick-400b-a17b"])
def test_unported_families_raise_at_construction(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LM(get_smoke_config(arch), None, "cpu")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_mamba2_builds_with_the_reference_leaves(smoke):
    """mamba2 (ssm) builds, at full width and depth too (on the meta
    device: no memory), with the reference's parameter leaves, shapes and
    dtypes, mixer leaves ``w_in``, ``conv_w``, ``a_log``, ``dt_bias``,
    ``d_skip``, ``norm_w``, ``w_out`` and no norm2 or FFN."""
    arch = "mamba2-1.3b"
    rcfg = r_smoke(arch) if smoke else r_get_config(arch)
    tcfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = LM(tcfg, None, "cpu" if smoke else "meta")
    shapes = jax.eval_shape(lambda k: r_init_model(rcfg, k)[0],
                            jax.random.PRNGKey(0))
    # stand-ins of the leaves' shapes and dtypes that hold no memory
    empty = jax.tree.map(lambda sd: np.broadcast_to(np.zeros((), sd.dtype),
                                                    sd.shape), shapes)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            lm_named_from_tree(tcfg, empty).items()}
    got = {k: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for k, p in model.named_parameters()}
    assert got == want
    assert {k.split(".", 3)[-1] for k in got if k.startswith("layers.")} == {
        "w", "w_in", "conv_w", "a_log", "dt_bias", "d_skip", "norm_w",
        "w_out"}
    assert len(model.layers) == rcfg.n_layers


def test_init_model_without_a_device_runs_on_the_card_or_raises():
    """``init_model`` resolves its device as every entry point does: cuda
    by default, and without a card an error, never a silent CPU model."""
    cfg = get_smoke_config("qwen3-1.7b")
    if torch.cuda.is_available():
        assert next(init_model(cfg).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_model(cfg)
    assert next(init_model(cfg, device="cpu").parameters()).device.type == \
        "cpu"


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match(arch):
    rcfg, tcfg, params, model, batch, tbatch = _setup(arch)

    def f(p):
        h, _ = r_forward_hidden(rcfg, p, batch["tokens"])
        return r_lm_loss(rcfg, p, h, batch["labels"]), h

    (want_loss, want_h), want_g = jax.value_and_grad(f, has_aux=True)(params)
    h, _ = forward_hidden(tcfg, model, tbatch["tokens"])
    loss = lm_loss(tcfg, model, h, tbatch["labels"])
    want_h = np.asarray(want_h)
    assert np.abs(h.detach().numpy() - want_h).max() <= \
        2e-5 * np.abs(want_h).max()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    names = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(names.values()))
    _leaves_close(jax.tree.map(np.asarray, want_g),
                  lm_grads_to_numpy(tcfg, dict(zip(names, grads))))


def _step0_leaves(rcfg, tcfg, params32, dtypes):
    """Step 0's loss and gradient leaves (float64 numpy, the reference's
    leaf order) on both sides from the same params (float32 numpy holding
    bf16-exact values).  The reference gets each leaf in its dtype from
    ``dtypes`` (what its ``init_model`` gives that leaf); the port casts
    them as its own model does."""
    batch = r_lm_batch(rcfg, 0, 0, BATCH, SEQ)
    params = jax.tree.map(jnp.asarray, params32, dtypes)

    def f(p):
        h, _ = r_forward_hidden(rcfg, p, batch["tokens"])
        return r_lm_loss(rcfg, p, h, batch["labels"])

    r_loss, r_grads = jax.jit(jax.value_and_grad(f))(params)
    model = lm_params_from_numpy(tcfg, params32, "cpu")
    h, _ = forward_hidden(tcfg, model, torch.from_numpy(
        np.array(batch["tokens"])))
    loss = lm_loss(tcfg, model, h, torch.from_numpy(
        np.array(batch["labels"])))
    names = dict(model.named_parameters())
    grads = lm_grads_to_numpy(tcfg, dict(zip(names, torch.autograd.grad(
        loss, list(names.values())))))
    as64 = lambda tree: [np.asarray(x, np.float64)
                         for x in jax.tree.leaves(tree)]
    return (float(r_loss), as64(r_grads)), (float(loss.detach()),
                                            as64(grads))


def _gaps(got, want):
    """Each leaf's ||got - want|| / ||want||."""
    return np.array([np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                     for a, b in zip(got, want)])


def _bf16_step0_readings(arch):
    """Step 0's bf16 and float32 losses and leaves on both sides, params
    carried across with each leaf in the dtype the reference's
    ``init_model`` gives it (mamba's ``a_log``, ``dt_bias`` and ``d_skip``
    stay float32 on both sides)."""
    r16, t16 = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
    r32, t32 = _cfgs(arch)
    params, _ = r_init_model(r16, jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    dtypes16 = jax.tree.map(lambda a: a.dtype, params)
    dtypes32 = jax.tree.map(lambda a: np.dtype(np.float32), params)
    (rl16, rg16), (tl16, tg16) = _step0_leaves(r16, t16, params32, dtypes16)
    (_, rg32), (_, tg32) = _step0_leaves(r32, t32, params32, dtypes32)
    return dict(ref_loss=rl16, port_loss=tl16, between=_gaps(tg16, rg16),
                ref_own=_gaps(rg16, rg32), port_own=_gaps(tg16, tg32),
                port_to_ref32=_gaps(tg16, rg32))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_bf16_step0_matches_reference(arch):
    """Step 0 in bfloat16 (activations and parameters) on both sides:
    losses within 1e-4 relative; the median and the worst leaf gap
    between the sides at most 1.1x and 1.25x the smaller of the two
    sides' own bf16-versus-float32 medians and worsts (the margins of
    ``chip_smoke.py``'s ``BF16_STEP0_MARGIN``).  A leaf whose reference
    bf16 value is itself further than that limit from the reference's
    float32 one is held to the reference's float32 instead, at the same
    limit: mamba2's ``d_skip``, whose cotangent the reference's CPU
    gradient sums in bf16 (``test_reference_sums_d_skip_cotangent_in_bf16``)
    while the port sums it in float32."""
    r = _bf16_step0_readings(arch)
    assert r["port_loss"] == pytest.approx(r["ref_loss"], rel=1e-4)
    between, ref_own, port_own = r["between"], r["ref_own"], r["port_own"]
    assert np.median(between) <= 1.1 * min(np.median(ref_own),
                                           np.median(port_own))
    limit = 1.25 * min(ref_own.max(), port_own.max())
    held = np.where(ref_own > limit, r["port_to_ref32"], between)
    assert held.max() <= limit, r


def test_reference_sums_d_skip_cotangent_in_bf16():
    """Why mamba2's ``d_skip`` is held to the reference's float32 above:
    the gradient of ``xh * d_skip.astype(bf16)`` (``mamba.py``'s skip
    term, d_skip float32) over (B, S, P) = (4, 64, 64) comes out of jax on
    the CPU >= 10x further from the exact sum than out of torch, which
    accumulates the bf16 products in float32."""
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((BATCH, SEQ, 4, 64)).astype(np.float32)
    dy = rng.standard_normal((BATCH, SEQ, 4, 64)).astype(np.float32)
    xb, db = jnp.asarray(xh, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    exact = (np.asarray(xb, np.float64) *
             np.asarray(db, np.float64)).sum((0, 1, 3))
    want = jax.grad(lambda d: jnp.sum(
        xb * d[None, None, :, None].astype(jnp.bfloat16) * db))(
        jnp.ones(4, jnp.float32))
    d = torch.ones(4, requires_grad=True)
    (torch.from_numpy(xh).bfloat16() * d[None, None, :, None].bfloat16() *
     torch.from_numpy(dy).bfloat16()).float().sum().backward()
    err = lambda g: np.linalg.norm(np.asarray(g, np.float64) - exact) / \
        np.linalg.norm(exact)
    assert err(want) >= 10 * err(d.grad.numpy())


def test_mrope_forward_matches():
    """qwen2-vl's M-RoPE: three position streams (temporal, height, width)
    driving sections of the frequency slots, with frontend embeddings."""
    rcfg, tcfg, params, model, batch, tbatch = _setup("qwen2-vl-7b")
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 50, (3, BATCH, SEQ)).astype(np.int32)
    want, _ = r_forward_hidden(rcfg, params, batch["tokens"],
                               positions=jnp.asarray(pos),
                               input_embeds=batch["input_embeds"])
    got, _ = forward_hidden(tcfg, model, tbatch["tokens"],
                            positions=torch.from_numpy(pos),
                            input_embeds=tbatch["input_embeds"])
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= \
        2e-5 * np.abs(want).max()


# ------------------------------------------------------------ train steps
def _ref_steps(rcfg, params, n, grad_accum=1):
    opt = r_make_optimizer(ROptConfig())
    st = opt.init(params)
    step = jax.jit(r_make_train_step(rcfg, opt, grad_accum=grad_accum))
    metrics = []
    for i in range(n):
        params, st, m = step(params, st, r_lm_batch(rcfg, 0, i, BATCH, SEQ))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, st, metrics


def _port_steps(rcfg, tcfg, model, n, grad_accum=1):
    opt = make_optimizer(OptimizerConfig())
    st = opt.init(dict(model.named_parameters()))
    step = make_train_step(tcfg, opt, grad_accum=grad_accum)
    metrics = []
    for i in range(n):
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in r_lm_batch(rcfg, 0, i, BATCH, SEQ).items()}
        model, st, m = step(model, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, st, metrics


def _check_steps(arch, n, grad_accum=1):
    rcfg, tcfg, params, model, _, _ = _setup(arch)
    want_p, want_st, want_m = _ref_steps(rcfg, params, n, grad_accum)
    model, st, got_m = _port_steps(rcfg, tcfg, model, n, grad_accum)
    for w, g in zip(want_m, got_m):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    _leaves_close(jax.tree.map(np.asarray, want_p),
                  lm_params_to_numpy(tcfg, model))
    for k in ("m", "v"):
        _leaves_close(jax.tree.map(np.asarray, want_st[k]),
                      lm_grads_to_numpy(tcfg, st[k]))
    assert int(st["step"]) == int(want_st["step"]) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches(arch):
    _check_steps(arch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_matches(arch):
    _check_steps(arch, 1, grad_accum=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match(arch):
    _check_steps(arch, 3)


@pytest.mark.parametrize("ocfg", [
    dict(name="adamw", weight_decay=0.1),
    dict(name="adamw", grad_compression="bf16", moment_dtype="bfloat16"),
    dict(name="adamw", grad_compression="int8", grad_clip=0.0),
    dict(name="adafactor", weight_decay=0.01)], ids=lambda d: "-".join(
        f"{v}" for v in d.values()))
def test_optimizers_match(ocfg):
    """Two updates of every optimizer variant on the same float32 params
    and grads (a matrix, a stacked 3-D leaf, a vector), against the
    reference's: params and state within 1e-5 of each leaf's max |.|."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "stack": (3, 4, 7), "b": (9,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 3
              for k, s in shapes.items()} for _ in range(2)]
    ropt = r_make_optimizer(ROptConfig(**ocfg))
    topt = make_optimizer(OptimizerConfig(**ocfg))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rst = ropt.init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = topt.init(tp)
    for g in grads:
        rp, rst = ropt.update({k: jnp.asarray(v) for k, v in g.items()},
                              rst, rp)
        tp, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              tst, tp)
    to_np = lambda tree: jax.tree.map(
        lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                             np.float32), tree)
    _leaves_close(to_np(rp), to_np(tp), tol=1e-5)
    _leaves_close(to_np({k: v for k, v in rst.items() if k != "step"}),
                  to_np({k: v for k, v in tst.items() if k != "step"}),
                  tol=1e-5)
    assert int(tst["step"]) == int(rst["step"]) == 2


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,seed,step,batch,seq,host,n_hosts", [
    ("qwen3-1.7b", 0, 0, 4, 64, 0, 1), ("olmo-1b", 3, 7, 2, 33, 0, 1),
    ("smollm-360m", 1, 2, 4, 16, 1, 2), ("qwen2-vl-7b", 0, 1, 2, 32, 0, 1)])
def test_lm_batch_equals_reference(arch, seed, step, batch, seq, host,
                                   n_hosts):
    cfg_r, cfg_t = r_smoke(arch), get_smoke_config(arch)
    with golden_key_layout():
        want = r_lm_batch(cfg_r, seed, step, batch, seq, host, n_hosts)
        got = tlm.lm_batch(cfg_t, seed, step, batch, seq, host, n_hosts,
                           device="cpu")
    assert set(want) == set(got)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if "input_embeds" in want:
        # torch.erfinv and XLA's agree to float32 rounding, not bit for bit
        np.testing.assert_allclose(got["input_embeds"].numpy(),
                                   np.asarray(want["input_embeds"]),
                                   rtol=1e-5, atol=1e-7)


def test_lm_batch_equals_reference_in_partitionable_layout():
    """Under ``jax_threefry_partitionable=True`` (jax's default) on both
    sides, the tokens and labels equal the reference's, run live."""
    cfg_r, cfg_t = r_smoke("qwen3-1.7b"), get_smoke_config("qwen3-1.7b")
    with jax.threefry_partitionable(True), \
            trandom.threefry_partitionable(True):
        want = r_lm_batch(cfg_r, 2, 3, 4, 64, 0, 1)
        got = tlm.lm_batch(cfg_t, 2, 3, 4, 64, 0, 1, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("rows,vocab", [(9, 512), (12, 77)])
def test_categorical_slices_equal_the_whole_draw(monkeypatch, rows, vocab):
    """The Gumbel draw made in slices of whole rows gives the argmax of
    the one (rows, V) draw, for odd and even word counts."""
    key = trandom.fold_in(trandom.PRNGKey(3), 5)
    logp = tlm.zipf_logits(vocab)
    g = trandom.gumbel(key, (rows, vocab))
    want = torch.argmax(g + logp, dim=-1)
    monkeypatch.setattr(tlm, "SLICE_WORDS", 2 * vocab + 1)
    assert torch.equal(tlm.categorical_rows(key, logp, rows), want)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_bits_at_equals_random_bits(n):
    key = trandom.fold_in(trandom.PRNGKey(11), 2)
    whole = trandom.random_bits(key, (n,))
    pos = torch.arange(n, dtype=torch.int64)
    assert torch.equal(trandom.bits_at(key, n, pos), whole)
    assert torch.equal(trandom.bits_at(key, n, pos[n // 3:]),
                       whole[n // 3:])


# ----------------------------------------------------------------- launcher
def test_launcher_trains_two_smoke_steps_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "2",
                "--batch", "2", "--seq-len", "32", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


def test_launcher_trains_two_mamba2_smoke_steps_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "2",
                "--batch", "2", "--seq-len", "64", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out
