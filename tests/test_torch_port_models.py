"""PyTorch port, VGG-16 and the MLP (horovod_tpu_torch/models/vgg.py,
models/mlp.py) held against the JAX package's models/vgg.py and
models/mlp.py on the same weights (the JAX package's own init, carried
over by horovod_tpu_torch.convert) and the same numpy inputs.

VGG-16 at 64x64 (a 2x2 grid before the classifier, so a flatten in
another order than the reference's H, W, C would permute ``fc1``'s
rows), 10 classes, batch 2, as the reference's
``test_vgg16_forward_loss_and_grads``; MLP 784-256-128-10, batch 8.

Tolerances: f32 VGG logits rtol 1e-4 / atol 1e-5 and loss rtol 1e-5 (the
convolutions sum in another order), gradients 1e-3 relative L2 per
tensor; bf16 VGG logits within 5% of their largest value (bf16 keeps 8
significant bits and each side rounds 16 layers); MLP logits, loss and
gradients rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch.convert import mlp_params_from_jax, vgg_params_from_jax
from horovod_tpu_torch.models import mlp as tmlp
from horovod_tpu_torch.models import vgg as tvgg

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def vgg_side():
    cfg = jvgg.VGGConfig(num_classes=10, dtype=jnp.float32, image_size=64)
    params = jvgg.vgg16_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 64, 64, 3)) * 0.1).astype(np.float32)
    y = np.array([1, 2], np.int32)
    loss, grads = jax.jit(jax.value_and_grad(jvgg.vgg_loss),
                          static_argnums=(3,))(params, jnp.asarray(x),
                                               jnp.asarray(y), cfg)
    out = {"params": jax.tree.map(np.asarray, params), "x": x, "y": y,
           "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
    for dt in ("f32", "bf16"):
        c = jvgg.VGGConfig(num_classes=10, dtype=_JDT[dt], image_size=64)
        out[dt] = np.asarray(jax.jit(jvgg.vgg_apply, static_argnums=(2,))(
            params, jnp.asarray(x), c), np.float32)
    return out


def _vgg(side, dt="f32"):
    cfg = tvgg.VGGConfig(num_classes=10, dtype=_TDT[dt], image_size=64)
    model = tvgg.vgg16_init(0, cfg, device="cpu")
    model.load_state_dict(vgg_params_from_jax(side["params"]))
    return model


def test_vgg16_parameters_and_names(vgg_side):
    model = _vgg(vgg_side)
    n = sum(p.numel() for p in model.parameters())
    assert 30e6 < n < 45e6        # 13 convs (~14.7M) + FCs at 64 px
    names = {f"{layer}.{k}" for layer, leaves in vgg_side["params"].items()
             for k in leaves}
    assert {k for k, _ in model.named_parameters()} == names


def test_vgg16_forward_loss_and_grads(vgg_side):
    model = _vgg(vgg_side)
    x, y = torch.from_numpy(vgg_side["x"]), torch.from_numpy(vgg_side["y"])
    logits = tvgg.vgg_apply(model, x)
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), vgg_side["f32"],
                               rtol=1e-4, atol=1e-5)
    loss = tvgg.vgg_loss(model, x, y)
    loss.backward()
    np.testing.assert_allclose(loss.item(), vgg_side["loss"], rtol=1e-5)
    want = {k: v.numpy() for k, v in
            vgg_params_from_jax(vgg_side["grads"]).items()}
    for k, p in model.named_parameters():
        d = np.linalg.norm(p.grad.numpy() - want[k])
        assert d <= 1e-3 * np.linalg.norm(want[k]) + 1e-12, (k, d)


def test_vgg16_bf16_forward(vgg_side):
    model = _vgg(vgg_side, "bf16")
    with torch.no_grad():
        logits = model(torch.from_numpy(vgg_side["x"]))
    want = vgg_side["bf16"]
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_mlp_matches_reference():
    params = jmlp.mlp_init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 784)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    logits = np.asarray(jmlp.mlp_apply(params, jnp.asarray(x)))
    loss, grads = jax.value_and_grad(jmlp.mlp_loss)(params, jnp.asarray(x),
                                                    jnp.asarray(y))
    model = tmlp.mlp_init(0, device="cpu")
    model.load_state_dict(mlp_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    got = tmlp.mlp_apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), logits, rtol=1e-5,
                               atol=1e-6)
    tloss = tmlp.mlp_loss(model, torch.from_numpy(x), torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert [tuple(p.shape) for p in model.parameters()] == [
        (784, 256), (256,), (256, 128), (128,), (128, 10), (10,)]


def test_model_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvgg.vgg16_init(0, tvgg.VGGConfig(image_size=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.mlp_init(0)
