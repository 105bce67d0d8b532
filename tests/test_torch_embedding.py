"""The appearance embedding's fixed-order backward (``ops/embedding.py``) on
the CPU: its plain version against the JAX package's one-hot matmul
gradient (``OneHotEmbed``), and bit for bit against a loop that adds each
gradient row to its table row in ascending row order (the order the card's
kernel, ``csrc/embedding_bwd.cu``, sums in; tests/test_torch_cuda.py holds
the kernel to the plain version bit for bit).

Tolerance against JAX: 1e-6 of the largest gradient entry (the one-hot
matmul sums the same rows in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.common import OneHotEmbed
from switch_nerf_torch.models.common import Embedding
from switch_nerf_torch.ops import embedding as temb


def _case(rows, num, feats, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, num, rows)
    idx[: rows // 4] = num - 1                # one row takes many
    g = (rng.normal(0, 1, (rows, feats))
         * rng.uniform(0, 50, (rows, 1))).astype(np.float32)
    table = rng.normal(0, 1, (num, feats)).astype(np.float32)
    return idx, g, table


def _loop_sum(idx, g, num):
    out = np.zeros((num, g.shape[1]), np.float32)
    for r in range(len(idx)):
        out[idx[r]] += g[r]
    return out


@pytest.mark.parametrize("rows,num,feats", [(4096, 7, 48), (1000, 300, 5),
                                            (64, 1, 48)])
def test_plain_backward_matches_jax_one_hot(rows, num, feats):
    idx, g, table = _case(rows, num, feats, seed=rows + num)
    emb = OneHotEmbed(num, feats)
    params = {"params": {"embedding": jnp.asarray(table)}}
    out, vjp = jax.vjp(lambda p: emb.apply(p, jnp.asarray(idx)), params)
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref["params"]["embedding"])

    module = Embedding(num, feats)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(table))
    y = module(torch.from_numpy(idx))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    y.backward(torch.from_numpy(g))
    err = np.abs(module.weight.grad.numpy() - ref).max()
    assert err <= 1e-6 * np.abs(ref).max(), err


@pytest.mark.parametrize("rows,num,feats", [(32768, 40, 48), (777, 3, 7)])
def test_plain_backward_is_the_ascending_loop_sum(rows, num, feats):
    """Bit for bit the loop sum; the table rows no index names stay 0."""
    idx, g, _ = _case(rows, num + 2, feats, seed=rows)
    idx = idx % num
    got = temb.embedding_bwd(torch.from_numpy(idx), torch.from_numpy(g),
                             num + 2)
    want = _loop_sum(idx, g, num + 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[num:].any()


def _layout(layout, rows, num, seed):
    """Indices in an order the kernel's grouping pass must handle: runs of
    a ray's 64 samples shuffled row by row ("unsorted"), or two table rows
    in turn, every row its own run ("alternating")."""
    rng = np.random.default_rng(seed)
    if layout == "unsorted":
        return rng.permutation(np.repeat(rng.integers(0, num, rows // 64),
                                         64))
    return np.arange(rows) % 2 * (num - 1)


@pytest.mark.parametrize("layout", ["unsorted", "alternating"])
def test_plain_backward_in_any_row_order(layout):
    """The plain version on unsorted and alternating indices: within 1e-6
    of JAX's one-hot gradient (relative to its largest entry) and bit for
    bit the ascending loop sum."""
    rows, num, feats = 4096, 33, 48
    idx = _layout(layout, rows, num, seed=rows + len(layout))
    _, g, table = _case(rows, num, feats, seed=len(layout))
    emb = OneHotEmbed(num, feats)
    params = {"params": {"embedding": jnp.asarray(table)}}
    _, vjp = jax.vjp(lambda p: emb.apply(p, jnp.asarray(idx)), params)
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref["params"]["embedding"])

    module = Embedding(num, feats)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(table))
    module(torch.from_numpy(idx)).backward(torch.from_numpy(g))
    got = module.weight.grad.numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(got, _loop_sum(idx, g, num))


def test_backward_through_autograd_is_the_plain_version():
    """EmbeddingFn's gradient (indices of any shape, the weight a leaf that
    also takes other gradient) equals the plain version's sum plus the
    other term, and the forward is the row gather."""
    idx, g, table = _case(600, 9, 12, seed=3)
    weight = torch.from_numpy(table).requires_grad_()
    idx2 = torch.from_numpy(idx).reshape(20, 30)
    y = temb.embedding(idx2, weight)
    assert torch.equal(y, weight.detach()[idx2])
    (y * torch.from_numpy(g).reshape(20, 30, 12)).sum().backward()
    want = temb.embedding_bwd_plain(torch.from_numpy(idx),
                                    torch.from_numpy(g), 9)
    assert torch.equal(weight.grad, want)
    with torch.no_grad():
        assert torch.equal(temb.embedding(idx2, weight), y.detach())
