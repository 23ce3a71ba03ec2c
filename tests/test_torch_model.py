"""repro_torch's dense transformer against the JAX package's, on shared
weights.

The JAX model is initialised with ``PRNGKey(0)``; its tree crosses the
weight bridge (``params_from_numpy``) into the port.  Both then prefill
the same tokens and take 4 greedy decode steps through a cache.  Logits
and the K/V cache are compared by each tensor's largest gap as a share
of its largest magnitude:

  f32   1e-4: the same function, its sums taken in other orders (about
        4e-6 measured here);
  bf16  8e-2, in the models' own dtype: bf16 keeps 8 significant bits,
        the two libraries round the bf16 products of every layer at other
        places, and the reference's init (fan_in over the layer count)
        makes attention nearly one-hot, so a rounding that flips a
        near-tied softmax row moves the logits by a few percent (up to
        4.1% over 12 seeds here).

On the CPU the port's prefill attention is the kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models.model import build_model as jax_build
from repro.models.param import init_params as jax_init
from repro.models.transformer import transformer_defs as jax_defs
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.models.param import (ParamDef, init_params, param_bytes,
                                      param_count, params_from_numpy,
                                      tree_map_defs)

DENSE = ["qwen2_5_3b", "internlm2_20b", "granite_8b", "stablelm_3b"]
REL_TOL = {"float32": 1e-4, "bfloat16": 8e-2}


def _assert_close(port, ref, dtype="bfloat16"):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    gap = np.abs(port - ref).max()
    assert gap <= REL_TOL[dtype] * np.abs(ref).max(), (gap, np.abs(ref).max())


def _shared(arch, dtype="bfloat16"):
    jcfg = jax_arch(arch).smoke
    jm = jax_build(jcfg)
    jp = jax.tree.map(lambda a: a.astype(dtype),
                      jax_init(jm.param_defs(), jax.random.PRNGKey(0)))
    cfg = get_arch(arch).smoke
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, build_model(cfg), tp, cfg


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill, then 4 decode steps through a cache of the weights' dtype
    (the reference's init_cache is bf16; an f32 cache is set up here for
    the f32 case so that no bf16 rounding enters it)."""
    jm, jp, tm, tp, cfg = _shared(arch, dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 37)) \
        .astype(np.int32)
    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _assert_close(tlast.float(), jlast, dtype)
    for key in ("k", "v"):
        _assert_close(tcache[key].float(), jcache[key], dtype)
    np.testing.assert_array_equal(tcache["pos"].numpy(), jcache["pos"])

    s = 48                                   # room for the decode steps
    jc = {k: v.astype(dtype) if k != "pos" else v
          for k, v in jm.init_cache(2, s).items()}
    tc = T.init_cache(cfg, 2, s, dtype=tp.ln_f.dtype, device="cpu")
    for key in ("k", "v"):
        jc[key] = jc[key].at[:, :, :37].set(jcache[key])
        tc[key][:, :, :37] = tcache[key]
    jc["pos"], tc["pos"] = jcache["pos"], tcache["pos"].clone()
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    for _ in range(4):
        jlogits, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tlogits, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _assert_close(tlogits.float(), jlogits, dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for key in ("k", "v"):
        _assert_close(tc[key].float(), jc[key], dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    """Training-shape forward: logits at every position, and prefill's
    last row equals forward's last row."""
    jm, jp, tm, tp, cfg = _shared(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)) \
        .astype(np.int32)
    jlogits, _, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, aux, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
        tlast, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    _assert_close(tlogits.float(), jlogits)
    torch.testing.assert_close(tlast, tlogits[:, -1], atol=0, rtol=0)


def test_decode_cache_is_circular():
    """Writes land at pos % S: decoding past the cache's length overwrites
    the oldest row, as the reference's decode does."""
    jm, jp, tm, tp, cfg = _shared("qwen2_5_3b")
    s = 4
    jc, tc = jm.init_cache(1, s), tm.init_cache(1, s, device="cpu")
    tok = np.array([[5]], np.int32)
    for _ in range(6):
        jlogits, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tlogits, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _assert_close(tlogits.float(), jlogits)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    assert int(tc["pos"][0]) == 6
    _assert_close(tc["k"].float(), jc["k"])


def _flatten(tree, path=""):
    """{'/'-joined path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{path}/{k}" if path else k))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_param_names_and_shapes_equal_transformer_defs(arch):
    """The port's defs are the reference's; its module state maps back onto
    them name for name, and the bridge keeps every value."""
    cfg = get_arch(arch).smoke
    defs = T.transformer_defs(cfg)
    flat = {}
    tree_map_defs(lambda p, d: flat.__setitem__(p, d), defs)
    ref_flat = _flatten(jax_defs(jax_arch(arch).smoke))
    assert set(flat) == set(ref_flat)
    for path, d in flat.items():
        r = ref_flat[path]
        assert (d.shape, d.axes, d.dtype, d.init, d.scale) == \
            (r.shape, r.axes, r.dtype, r.init, r.scale), path
    assert param_count(defs) == cfg.param_count()

    _, jp, _, tp, _ = _shared(arch)
    back, jflat = _flatten(tp.to_tree()), _flatten(jp)
    assert set(back) == set(flat)
    for path, t in back.items():
        assert tuple(t.shape) == flat[path].shape, path
        assert str(t.dtype).split(".")[-1] == flat[path].dtype, path
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jflat[path]).astype(np.float32))
    assert sum(p.numel() for p in tp.parameters()) == param_count(defs)


def test_port_init_follows_the_reference_rules():
    """zeros, ones, normal(0.02) and fan_in = scale / sqrt(shape[0]) — the
    FIRST dim, the layer count for stacked block weights (a property of
    the reference the port keeps); bf16 as declared; one seed, one draw."""
    defs = {
        "z": ParamDef((4, 8), (None, None), init="zeros"),
        "o": ParamDef((8,), (None,), init="ones"),
        "n": ParamDef((64, 512), (None, None), init="normal"),
        "f": ParamDef((9, 64, 256), ("layers", None, None), init="fan_in",
                      scale=1.0),
        "g": ParamDef((4, 32, 256), ("layers", None, None), init="fan_in",
                      scale=2.0),
        "s": ParamDef((128, 256), (None, None), init="normal", scale=0.5,
                      dtype="float32"),
    }
    p = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    assert p["z"].dtype == torch.bfloat16 and not p["z"].any()
    assert (p["o"] == 1).all()
    assert p["s"].dtype == torch.float32
    for name, std in (("n", 0.02), ("f", 1.0 / 3.0), ("g", 1.0),
                      ("s", 0.5)):
        got = float(p[name].float().std())
        assert abs(got - std) < 0.03 * std, (name, got, std)
        assert abs(float(p[name].float().mean())) < 0.03 * std, name
    again = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in defs)
    assert param_bytes(defs) == 2 * (32 + 8 + 64 * 512 + 9 * 64 * 256
                                     + 4 * 32 * 256) + 4 * 128 * 256


def test_port_init_matches_reference_statistics_on_qwen_smoke():
    """The port's own random model and the reference's have the same
    per-tensor spread (not the same numbers: the generators differ)."""
    cfg = get_arch("qwen2_5_3b").smoke
    port = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu").to_tree()
    ref = jax_init(jax_defs(jax_arch("qwen2_5_3b").smoke),
                   jax.random.PRNGKey(0))
    for name in ("wq", "wk", "w_gate", "w_down"):
        a = float(port["blocks"][name].float().std())
        b = float(np.asarray(ref["blocks"][name], np.float32).std())
        assert abs(a - b) < 0.05 * b, (name, a, b)
    assert abs(float(port["embed_tokens"].float().std()) - 0.02) < 1e-3


@pytest.mark.parametrize("arch,item", [
    ("grok1_314b", "A10"), ("dbrx_132b", "A10"), ("mamba2_1_3b", "A9"),
    ("zamba2_2_7b", "A9"), ("internvl2_26b", "A11"),
    ("hubert_xlarge", "A11")])
def test_unported_families_raise_naming_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(get_arch(arch).smoke)
