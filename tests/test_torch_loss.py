"""``LM.loss`` of every family's smoke config held against the reference's
on the CPU, from the reference's parameters on a pipeline batch (tokens,
labels, mask and the side inputs), with the gradients of fp32 copies and
the gradient norm of a bf16 run.

Families: dense GQA (``codeqwen1.5-7b``), MoE (``moonshot-v1-16b-a3b``), MLA
(``deepseek-v3-671b``), the RG-LRU hybrid (``recurrentgemma-2b``), RWKV6
(``rwkv6-3b``), vision embeddings (``internvl2-2b``), audio codebooks with
cross-attention (``musicgen-medium``: logits reshaped per codebook, the
loss averaged over the codebooks).

Tolerances, each with the value this file measured beside it:
  - fp32 copies (``param_dtype`` and ``compute_dtype`` float32): the loss
    within 1e-5 relative (at most 2.2e-7 measured), every gradient leaf
    within 1e-5 of its largest magnitude (at most 5.0e-6 measured, rwkv6's
    ``embed``: its chunked WKV's fp32 decays sum in another order; 1.5e-6
    or less elsewhere; ``tests/test_torch_train.py`` holds the dense
    model's entry by entry);
  - the bf16 smoke configs: the loss within 2e-3 relative (at most 3.5e-4
    measured) and, for ``codeqwen1.5-7b``, the global gradient norm within
    2e-2 relative (4.3e-4 measured; 1.8e-3 at most over the families). The port rounds every bf16 op where the reference's
    code does, but XLA fuses sums and products in the scanned body and
    keeps fp32 between them, so the bf16 activations move by an ulp and
    the gradients' sums with them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import smoke_config as jsmoke
from repro.models.model import LM as JLM
from repro.optim.adamw import _global_norm as j_global_norm
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import LM
from repro_torch.optim.adamw import _global_norm
from repro_torch.train.step import to_device

FAMILIES = ("codeqwen1.5-7b", "moonshot-v1-16b-a3b", "deepseek-v3-671b", "recurrentgemma-2b",
            "rwkv6-3b", "internvl2-2b", "musicgen-medium")
F32 = (dict(param_dtype=jnp.float32, compute_dtype=jnp.float32),
       dict(param_dtype=torch.float32, compute_dtype=torch.float32))


def models(arch, fp32):
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    if fp32:
        jcfg, tcfg = dataclasses.replace(jcfg, **F32[0]), dataclasses.replace(tcfg, **F32[1])
    jm, tm = JLM(jcfg), LM(tcfg)
    jp = jm.constrain(jm.init(jax.random.PRNGKey(0)))
    tm.load_params(params_from_numpy(tp.to_numpy(jp), "cpu"))
    batch = SyntheticTokens(tcfg, DataConfig(seq_len=16, global_batch=2)).batch(3)
    return jm, jp, tm, batch


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def losses_and_grads(jm, jp, tm, batch):
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = flatten(tm.params)[0]
    for p in leaves:
        p.requires_grad_(True)
    tl, taux = tm.loss(to_device(batch, "cpu"))
    assert set(taux) == set(jaux) == {"loss", "nll_mean"}
    tg = torch.autograd.grad(tl, leaves, allow_unused=True, materialize_grads=True)
    return jl, jg, tl.detach(), list(tg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fp32_loss_and_gradients_match(arch):
    jm, jp, tm, batch = models(arch, fp32=True)
    jl, jg, tl, tg = losses_and_grads(jm, jp, tm, batch)
    assert rel(tl, jl) <= 1e-5, (float(tl), float(jl))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        a, b = np.asarray(a), b.numpy()
        err = float(np.abs(a - b).max())
        assert err <= 1e-5 * float(np.abs(a).max()), (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_loss_matches(arch):
    jm, jp, tm, batch = models(arch, fp32=False)
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = tm.loss(to_device(batch, "cpu"))
    assert rel(tl, jl) <= 2e-3, (float(tl), float(jl))


def test_bf16_gradient_norm_matches():
    jm, jp, tm, batch = models("codeqwen1.5-7b", fp32=False)
    jl, jg, tl, tg = losses_and_grads(jm, jp, tm, batch)
    assert rel(tl, jl) <= 2e-3
    assert rel(_global_norm(tg), j_global_norm(jg)) <= 2e-2


def test_masked_loss_matches():
    """A mask drops positions from the mean, as the reference's; and
    ``loss(params=)`` runs another tree than the model's."""
    jm, jp, tm, batch = models("codeqwen1.5-7b", fp32=True)
    batch["loss_mask"][:, ::3] = 0.0
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = tm.loss(to_device(batch, "cpu"))
        own = tm.params
        tm.init(torch.Generator().manual_seed(7), "cpu")
        other, _ = tm.loss(to_device(batch, "cpu"), params=own)
    assert rel(tl, jl) <= 1e-5
    assert torch.equal(other, tl)
