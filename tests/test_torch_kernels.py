"""The plain versions of the port's CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU, automatic off the
TPU), on the same seeded inputs, forward and backward; the wrappers' CPU
dispatch and autograd. The case lists, and the tests of each kernel
against its plain version on the card, live in test_torch_cuda.py,
which imports no JAX so that it runs on the card's machine.

Tolerance: both sides compute in float32 — rtol=1e-5, atol=1e-6 (the
biases' gradients, sums over N*H*W elements, atol=1e-5).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.ops.pallas_epilogue import bias_relu as j_bias_relu
from sparknet_tpu.ops.pallas_epilogue import bias_relu_lrn as j_bias_relu_lrn
from sparknet_tpu.ops.pallas_lrn import _call_bwd as j_call_bwd
from sparknet_tpu.ops.pallas_lrn import lrn_across as j_lrn_across
from sparknet_tpu_torch.ops import cuda_build
from sparknet_tpu_torch.ops import cuda_epilogue as ce
from sparknet_tpu_torch.ops import cuda_lrn as cl
from test_torch_cuda import BWD_CASES, EPI_SHAPES, LRN_CASES, _x

def _close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,size,alpha,beta,k", LRN_CASES)
def test_lrn_across_plain_matches_pallas(shape, size, alpha, beta, k):
    x = _x(shape, 5, scale=3.0)
    _close(cl.lrn_across_plain(torch.from_numpy(x), size, alpha, beta, k),
           j_lrn_across(jnp.asarray(x), size, alpha, beta, k))


@pytest.mark.parametrize("shape", EPI_SHAPES)
def test_bias_relu_plain_matches_pallas(shape):
    x, b = _x(shape, 11), _x(shape[1:2], 12)
    _close(ce.bias_relu_plain(torch.from_numpy(x), torch.from_numpy(b)),
           j_bias_relu(jnp.asarray(x), jnp.asarray(b)))


@pytest.mark.parametrize("shape", EPI_SHAPES)
@pytest.mark.parametrize("size,alpha,beta,k", [(5, 1e-4, 0.75, 1.0),
                                               (4, 1e-2, 0.6, 2.0)])
def test_bias_relu_lrn_plain_matches_pallas(shape, size, alpha, beta, k):
    x, b = _x(shape, 13, scale=3.0), _x(shape[1:2], 14)
    _close(ce.bias_relu_lrn_plain(torch.from_numpy(x), torch.from_numpy(b),
                                  size, alpha, beta, k),
           j_bias_relu_lrn(jnp.asarray(x), jnp.asarray(b), size, alpha,
                           beta, k))


@pytest.mark.parametrize("shape,size,alpha,beta,k", BWD_CASES)
def test_lrn_bwd_plain_matches_pallas_bwd_kernel(shape, size, alpha, beta,
                                                 k):
    x, g = _x(shape, 21, scale=3.0), _x(shape, 22)
    ref = j_call_bwd(jnp.asarray(x), jnp.asarray(g), size, alpha, beta, k,
                     interpret=True)
    _close(cl.lrn_across_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   size, alpha, beta, k), ref)


@pytest.mark.parametrize("shape,size,alpha,beta,k", BWD_CASES)
def test_lrn_autograd_matches_jax_grad(shape, size, alpha, beta, k):
    x, g = _x(shape, 23, scale=3.0), _x(shape, 24)
    _, vjp = jax.vjp(lambda v: j_lrn_across(v, size, alpha, beta, k),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    cl.lrn_across(xt, size, alpha, beta, k).backward(torch.from_numpy(g))
    _close(xt.grad, ref)


def _epilogue_grads(fn, x, b, g):
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    fn(xt, bt).backward(torch.from_numpy(g))
    return xt.grad, bt.grad


def _close_bias(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", EPI_SHAPES)
@pytest.mark.parametrize("size,alpha,beta,k", [(5, 1e-4, 0.75, 1.0),
                                               (4, 1e-2, 0.6, 2.0)])
def test_bias_relu_lrn_grads_match_jax_vjp(shape, size, alpha, beta, k):
    x, b = _x(shape, 25, scale=3.0), _x(shape[1:2], 26)
    g = _x(shape, 27)
    _, vjp = jax.vjp(lambda v, c: j_bias_relu_lrn(v, c, size, alpha, beta,
                                                  k),
                     jnp.asarray(x), jnp.asarray(b))
    rdx, rdb = vjp(jnp.asarray(g))
    dx, db = _epilogue_grads(
        lambda v, c: ce.bias_relu_lrn(v, c, size, alpha, beta, k), x, b, g)
    _close(dx, rdx)
    _close_bias(db, rdb)
    pdx, pdb = ce.bias_relu_lrn_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(g), size,
        alpha, beta, k)
    _close(pdx, rdx)
    _close_bias(pdb, rdb)


@pytest.mark.parametrize("shape", EPI_SHAPES)
def test_bias_relu_grads_match_jax_vjp(shape):
    x, b, g = _x(shape, 28), _x(shape[1:2], 29), _x(shape, 30)
    _, vjp = jax.vjp(j_bias_relu, jnp.asarray(x), jnp.asarray(b))
    rdx, rdb = vjp(jnp.asarray(g))
    dx, db = _epilogue_grads(ce.bias_relu, x, b, g)
    _close(dx, rdx)
    _close_bias(db, rdb)


def test_bf16_epilogue_bwd_forms_y_in_bf16():
    # the JAX backward rounds y = relu(x + b) to the storage type before
    # the LRN window; the plain backward must do the same
    x = torch.from_numpy(_x((1, 16, 4, 9), 31, scale=2.0)).to(torch.bfloat16)
    b = torch.from_numpy(_x((16,), 32)).to(torch.bfloat16)
    g = torch.from_numpy(_x((1, 16, 4, 9), 33)).to(torch.bfloat16)
    dx, db = ce.bias_relu_lrn_bwd_plain(x, b, g, 5, 1e-2, 0.75, 1.0)
    assert dx.dtype == db.dtype == torch.bfloat16
    y = torch.relu(x + b.reshape(1, -1, 1, 1))
    assert y.dtype == torch.bfloat16
    dy = cl.lrn_across_bwd_plain(y.float(), g.float(), 5, 1e-2, 0.75, 1.0)
    ref = torch.where(y.float() > 0, dy, torch.zeros_like(dy))
    assert torch.equal(dx, ref.to(torch.bfloat16))


def test_plain_versions_are_differentiable():
    x = torch.from_numpy(_x((1, 6, 3, 4), 2)).requires_grad_()
    b = torch.from_numpy(_x((6,), 3)).requires_grad_()
    (ce.bias_relu_lrn_plain(x, b, 5, 1e-2, 0.75, 1.0).sum()
     + cl.lrn_across_plain(x, 3, 1e-2, 0.75, 1.0).sum()).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert torch.isfinite(b.grad).all()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    fns = (cl.lrn_across, ce.bias_relu, ce.bias_relu_lrn,
           cl.lrn_across_bwd, ce.bias_relu_lrn_bwd)
    before = [f.launches for f in fns]
    x = torch.from_numpy(_x((2, 8, 5, 6), 7))
    b = torch.from_numpy(_x((8,), 8))
    g = torch.from_numpy(_x((2, 8, 5, 6), 9))
    assert torch.equal(cl.lrn_across(x, 5, 1e-4, 0.75, 1.0),
                       cl.lrn_across_plain(x, 5, 1e-4, 0.75, 1.0))
    assert torch.equal(ce.bias_relu(x, b), ce.bias_relu_plain(x, b))
    assert torch.equal(ce.bias_relu_lrn(x, b, 5, 1e-4, 0.75, 1.0),
                       ce.bias_relu_lrn_plain(x, b, 5, 1e-4, 0.75, 1.0))
    assert torch.equal(cl.lrn_across_bwd(x, g, 5, 1e-4, 0.75, 1.0),
                       cl.lrn_across_bwd_plain(x, g, 5, 1e-4, 0.75, 1.0))
    for got, ref in zip(ce.bias_relu_lrn_bwd(x, b, g, 5, 1e-4, 0.75, 1.0),
                        ce.bias_relu_lrn_bwd_plain(x, b, g, 5, 1e-4, 0.75,
                                                   1.0)):
        assert torch.equal(got, ref)
    assert [f.launches for f in fns] == before == [0] * 5


def test_bf16_plain_rounds_once_from_f32():
    x = torch.from_numpy(_x((1, 16, 4, 9), 9, scale=2.0))
    b = torch.from_numpy(_x((16,), 10))
    xb = x.to(torch.bfloat16)
    got = ce.bias_relu_lrn_plain(xb, b, 5, 1e-2, 0.75, 1.0)
    assert got.dtype == torch.bfloat16
    ref = ce.bias_relu_lrn_plain(xb.float(), b.to(torch.bfloat16).float(),
                                 5, 1e-2, 0.75, 1.0).to(torch.bfloat16)
    assert torch.equal(got, ref)


def test_kernel_input_checks_refuse_non_cuda():
    with pytest.raises(ValueError, match="want cuda"):
        cuda_build.check_cuda_input(torch.zeros(2, 3, 4, 4), "lrn_across", 5)


def test_library_paths_are_per_source_and_stable():
    a = cuda_build.library_path("lrn")
    assert a.startswith(cuda_build.BUILD_DIR) and a.endswith(".so")
    assert a != cuda_build.library_path("epilogue")
    assert a == cuda_build.library_path("lrn")      # stable
    assert "lrn_bwd" in cuda_build.SOURCES


def test_a_macro_variant_builds_into_a_library_of_its_own():
    # the one-pass TF32 control of the f32 flash kernels: its own file,
    # named for its macro, never the library the wrappers load
    plain = cuda_build.library_path("flash_fwd")
    control = cuda_build.library_path("flash_fwd", cuda_build.TF32_ONE_PASS)
    assert control != plain and control.endswith(".so")
    assert "sparknet_flash_tf32_one_pass" in os.path.basename(control)
    assert control == cuda_build.library_path("flash_fwd",
                                              cuda_build.TF32_ONE_PASS)
