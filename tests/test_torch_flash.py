"""horovod_tpu_torch's attention (K6's plain versions,
``flash_attention_local`` and ``local_attention``) against the JAX package
on the CPU.

The same numpy inputs go through both packages. On the CPU the reference's
``flash_attention_local`` takes its materialized path (``local_attention``)
and the port's runs K6's plain PyTorch versions through its autograd
function. Tolerances, of each tensor's largest entry: fp32 results agree to
1e-5 (the same math, summed in another order); bf16 outputs to 2e-2 (both
sides round p and the output to bf16, at one ulp, 2^-8, apart at most),
fp16 outputs to 2e-3 (the same roundings at fp16's ulp, 2^-11). Head dims
other than 64 and 128 (16, 32, 80, 96) and q and k/v of different lengths
run the same functions; causal attention with Tq != Tk follows the library
kernel's rule (key <= query by absolute index), which the reference's CPU
path cannot express (it builds a (T, T) mask), so it is held against a
float64 computation of that rule.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from horovod_tpu.parallel.flash_attention import (
    flash_attention_local as jax_flash_attention_local)
from horovod_tpu.parallel.ring_attention import (
    local_attention as jax_local_attention)
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.parallel.flash_attention import flash_attention_local
from horovod_tpu_torch.parallel.ring_attention import local_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
B, H, D = 2, 3, 16


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


def _inputs(t, dtype, seed=0, n=3, d=D, tk=None):
    """n [B, T, H, D] arrays with values exact in ``dtype``, as (jax, torch)
    pairs; with ``tk``, the second and third (k and v) have tk rows."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rows = tk if tk is not None and i in (1, 2) else t
        a = jnp.asarray(rng.randn(B, rows, H, d), getattr(jnp, dtype))
        out.append((a, torch.tensor(np.asarray(a, np.float32)).to(
            getattr(torch, dtype))))
    return out


def _scores(q, k, causal):
    """Scaled fp32 scores [B, H, T, T] of [B, T, H, D] numpy inputs, masked
    with -inf."""
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    return s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bthk", "bhtk"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 17, 129])
def test_flash_forward_matches_reference(t, causal, layout, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(t, dtype)

    def lay(x, tr):   # a [B, T, H, D] array in ``layout``
        return tr(x, 1, 2) if layout == "bhtk" else x

    want = jax_flash_attention_local(
        *(lay(x, jnp.swapaxes) for x in (qj, kj, vj)), causal=causal,
        layout=layout)
    got = flash_attention_local(*(lay(x, torch.transpose)
                                  for x in (qt, kt, vt)),
                                causal=causal, layout=layout)
    assert got.dtype == qt.dtype and tuple(got.shape) == want.shape
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL[dtype])

    # the plain forward on [B, H, T, D] against local_attention, and its
    # lse against the logsumexp of the reference's scores
    o, lse = K.flash_attention_fwd_plain(
        *(x.transpose(1, 2) for x in (qt, kt, vt)), causal, D ** -0.5)
    ref = jax_local_attention(qj, kj, vj, causal=causal)
    _close(o.transpose(1, 2).float().numpy(), np.asarray(ref, np.float32),
           TOL[dtype])
    s = _scores(qt.float().numpy(), kt.float().numpy(), causal)
    mx = s.max(-1)
    want_lse = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    assert lse.dtype == torch.float32
    _close(lse.numpy(), want_lse, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 17])
def test_flash_backward_matches_jax_vjp(t, causal):
    """flash_attention_bwd_plain, and the autograd function's backward in
    both layouts, against jax.vjp of the reference's local_attention."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(t, "float32", 1, 4)
    _, vjp = jax.vjp(lambda a, b, c: jax_local_attention(a, b, c,
                                                         causal=causal),
                     qj, kj, vj)
    want = [np.asarray(g) for g in vjp(doj)]

    bhtk = [x.transpose(1, 2) for x in (qt, kt, vt, dot)]
    o, lse = K.flash_attention_fwd_plain(*bhtk[:3], causal, D ** -0.5)
    grads = K.flash_attention_bwd_plain(*bhtk[:3], o, lse, bhtk[3], causal,
                                        D ** -0.5)
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2).numpy(), w, 1e-5)

    for layout in ("bthk", "bhtk"):
        ins = [(x.transpose(1, 2) if layout == "bhtk" else x).clone()
               .requires_grad_() for x in (qt, kt, vt)]
        out = flash_attention_local(*ins, causal=causal, layout=layout)
        out.backward(dot.transpose(1, 2) if layout == "bhtk" else dot)
        for x, w in zip(ins, want):
            g = x.grad.transpose(1, 2) if layout == "bhtk" else x.grad
            _close(g.numpy(), w, 1e-5)


def test_flash_backward_under_a_global_lse_is_blockwise():
    """The backward's external lse and di (ring attention's interface): with
    the kv sequence cut into two blocks, each block's dk/dv under the global
    lse and di are that block's rows of the whole dk/dv, and the blocks' dq
    add up to the whole dq."""
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.tensor(rng.randn(B, H, 24, D), dtype=torch.float32)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = K.flash_attention_fwd_plain(q, k, v, False, scale)
    di = K.flash_bwd_pre_plain(o, do)
    dq, dk, dv = K.flash_attention_bwd_plain(q, k, v, o, lse, do, False,
                                             scale)
    dq_sum = torch.zeros_like(dq)
    for blk in (slice(0, 10), slice(10, 24)):
        kb, vb = k[:, :, blk], v[:, :, blk]
        dkb, dvb = K.flash_bwd_dkdv(q, kb, vb, do, lse, di, False, scale)
        _close(dkb.numpy(), dk[:, :, blk].numpy(), 1e-5)
        _close(dvb.numpy(), dv[:, :, blk].numpy(), 1e-5)
        dq_sum += K.flash_bwd_dq(q, kb, vb, do, lse, di, False, scale)
    _close(dq_sum.numpy(), dq.numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_matches_reference(causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(17, dtype, seed=3)
    want = jax_local_attention(qj, kj, vj, causal=causal)
    got = local_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL[dtype])


def test_flash_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.RandomState(4)
    q, k, v, do = (torch.tensor(rng.randn(1, 2, 9, 64), dtype=torch.bfloat16)
                   for _ in range(4))
    before = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, True, 0.125)
    o_ref, lse_ref = K.flash_attention_fwd_plain(q, k, v, True, 0.125)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    di = K.flash_bwd_pre(o, do)
    assert torch.equal(di, K.flash_bwd_pre_plain(o, do))
    for a, b in zip(K.flash_bwd_dkdv(q, k, v, do, lse, di, True, 0.125),
                    K.flash_bwd_dkdv_plain(q, k, v, do, lse, di, True,
                                           0.125)):
        assert torch.equal(a, b)
    assert torch.equal(K.flash_bwd_dq(q, k, v, do, lse, di, True, 0.125),
                       K.flash_bwd_dq_plain(q, k, v, do, lse, di, True,
                                            0.125))
    assert K.launch_counts() == before   # plain runs are no launches


def test_flash_attention_local_rejects_an_unknown_layout():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="unknown attention layout"):
        flash_attention_local(x, x, x, layout="bkht")


def _reference_out_and_grads(q, k, v, do, causal):
    """The reference's flash_attention_local (its CPU path) and jax.vjp of
    it, [B, T, H, D] in and out."""
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention_local(
        a, b, c, causal=causal), q, k, v)
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32)
                                            for g in vjp(do)]


def _port_out_and_grads(q, k, v, do, causal):
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_local(*ins, causal=causal)
    out.backward(do)
    return [out.detach()] + [x.grad for x in ins]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 80, 96])
def test_flash_head_dims_and_dtypes_match_reference(d, causal, dtype):
    """Head dims that the CUDA kernels pad to 64 or 128, in fp32, fp16 and
    bf16: output against the reference's, and (fp32) the gradients against
    jax.vjp of it."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(40, dtype, 7, 4, d)
    want = _reference_out_and_grads(qj, kj, vj, doj, causal)
    got = _port_out_and_grads(qt, kt, vt, dot, causal)
    assert got[0].dtype == qt.dtype and tuple(got[0].shape) == want[0].shape
    _close(got[0].float().numpy(), want[0], TOL[dtype])
    if dtype == "float32":
        for g, w in zip(got[1:], want[1:]):
            _close(g.numpy(), w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk", [(96, 160), (160, 96)])
def test_flash_full_attention_of_different_lengths_matches_reference(
        tq, tk, dtype):
    """Non-causal attention of tq queries over tk keys: output against the
    reference's and (fp32) gradients against jax.vjp of it."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(tq, dtype, 8, 4,
                                                       tk=tk)
    want = _reference_out_and_grads(qj, kj, vj, doj, False)
    got = _port_out_and_grads(qt, kt, vt, dot, False)
    assert tuple(got[0].shape) == (B, tq, H, D)
    _close(got[0].float().numpy(), want[0], TOL[dtype])
    if dtype == "float32":
        for g, w in zip(got[1:], want[1:]):
            _close(g.numpy(), w, TOL[dtype])


@pytest.mark.parametrize("tq,tk", [(96, 160), (160, 96), (5, 33)])
def test_flash_causal_attention_of_different_lengths_follows_library_rule(
        tq, tk):
    """Causal attention of tq queries over tk keys follows the Pallas
    library kernel's mask, ``col_ids <= row_ids`` by absolute index
    (jax/experimental/pallas/ops/tpu/flash_attention.py, the causal branch
    of _flash_attention_kernel): key j is visible to query i iff j <= i.
    The port's flash_attention_local (K6's plain versions on the CPU) and
    its gradients against a float64 computation of that rule."""
    (_, qt), (_, kt), (_, vt), (_, dot) = _inputs(tq, "float32", 9, 4,
                                                  tk=tk)
    got = _port_out_and_grads(qt, kt, vt, dot, True)
    q64, k64, v64 = (x.double().requires_grad_() for x in (qt, kt, vt))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / math.sqrt(D)
    visible = torch.arange(tk)[None, :] <= torch.arange(tq)[:, None]
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v64)
    want.backward(dot.double())
    for g, w in zip(got, (want.detach(), q64.grad, k64.grad, v64.grad)):
        _close(g.numpy(), w.numpy(), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 192, 256, 288, 320, 384, 512, 576, 640,
                               1024])
def test_flash_head_dims_above_128_match_reference(d, causal, dtype):
    """Head dims above 128 (160 padded to 192, 192 and 256: the Hopper wide
    kernels on the card; 288 padded to 320 and 320: the Hopper forward, O
    in two accumulators; 384 and 512: the forward's O split over blocks;
    576, 640 and 1024: the forward with S summed over the depth's slabs, Q
    resident; above 256 the deep dk/dv and dq, their output columns in
    groups over blocks and S and dP summed over the depth's slabs):
    flash_attention_local's output against the reference's
    and (fp32) its gradients against jax.vjp of it, and local_attention
    against the reference's. The CPU runs the port's plain versions and
    the reference's materialized fallback; TOL is per dtype."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(24, dtype, 12, 4, d)
    want = _reference_out_and_grads(qj, kj, vj, doj, causal)
    got = _port_out_and_grads(qt, kt, vt, dot, causal)
    assert got[0].dtype == qt.dtype and tuple(got[0].shape) == want[0].shape
    _close(got[0].float().numpy(), want[0], TOL[dtype])
    if dtype == "float32":
        for g, w in zip(got[1:], want[1:]):
            _close(g.numpy(), w, TOL[dtype])
    local = local_attention(qt, kt, vt, causal=causal)
    _close(local.float().numpy(),
           np.asarray(jax_local_attention(qj, kj, vj, causal=causal),
                      np.float32), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [288, 320, 576])
def test_flash_bf16_gradients_above_256_match_reference(d, causal):
    """bf16 gradients above head dim 256 (288 read in place by the 320
    instance, 320, and 576 in three groups of 192 dQ columns: the deep
    dk/dv and dq on the card): flash_attention_local's dq, dk and dv, on
    the CPU its plain versions (p and ds rounded to bf16 before their
    products, as the kernels round them), against jax.vjp of the
    reference's, within TOL["bfloat16"]."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(40, "bfloat16", 14, 4,
                                                       d)
    want = _reference_out_and_grads(qj, kj, vj, doj, causal)
    got = _port_out_and_grads(qt, kt, vt, dot, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        _close(g.float().numpy(), w, TOL["bfloat16"])


@pytest.mark.parametrize("d", [160, 192, 256, 288, 320, 384, 512, 576, 640,
                               1024])
def test_flash_head_dims_above_128_of_different_lengths(d):
    """Tq != Tk above head dim 128: full attention against the reference's
    (output and gradients, fp32), causal attention against a float64
    computation of the library kernel's rule (key <= query by absolute
    index)."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(20, "float32", 13, 4,
                                                       d, tk=36)
    want = _reference_out_and_grads(qj, kj, vj, doj, False)
    got = _port_out_and_grads(qt, kt, vt, dot, False)
    for g, w in zip(got, want):
        _close(g.numpy(), w, TOL["float32"])
    got = _port_out_and_grads(qt, kt, vt, dot, True)
    q64, k64, v64 = (x.double().requires_grad_() for x in (qt, kt, vt))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / math.sqrt(d)
    visible = torch.arange(36)[None, :] <= torch.arange(20)[:, None]
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v64)
    out.backward(dot.double())
    for g, w in zip(got, (out.detach(), q64.grad, k64.grad, v64.grad)):
        _close(g.numpy(), w.numpy(), TOL["float32"])
