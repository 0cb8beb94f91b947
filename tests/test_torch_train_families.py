"""Training and scoring the MoE family on the port (mixtral and
phi3.5-moe smoke configs), held to the JAX reference in float32 on the
same numpy weights and batch (``tests/_torch_train_parity.py``): the
forward's logits (rtol 2e-5, atol 2e-5 of the largest) and aux (rtol
1e-6); ``loss_fn``'s loss and aux under both ``ce_impl`` (rtol 1e-5);
every leaf's gradient against ``jax.grad`` (rtol 1e-4, atol 1e-6 of the
leaf's largest magnitude), also under each ``moe_impl`` ("a2a" takes
gshard with no mesh, as the reference does); remat none, dots and full
(the port against itself, rtol 1e-6); one ``make_train_step`` step from a
running job's Adam moments against the reference's (loss rtol 1e-5;
aux, grad_norm, lr, parameters and moments rtol 1e-4 / atol 1e-6).  The
SSM and hybrid configs are in ``test_torch_train_hybrid.py``, the
frontends in ``test_torch_train_frontends.py``."""
import pytest

import _torch_train_parity as P

ARCHS = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(autouse=True)
def _one_thread():
    with P.one_torch_thread():
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_the_reference(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("ce_impl", ["sharded", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference(arch, ce_impl):
    P.check_loss_and_grads(arch, ce_impl, atol_share=1e-6)


@pytest.mark.parametrize("impl", ["scatter", "a2a"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_impls_train_as_the_reference(arch, impl):
    """The loss, aux and every gradient under ``moe_impl`` "scatter" (the
    slot scatter / gather's backward) and "a2a", each against the
    reference's under the same ``moe_impl``."""
    P.check_loss_and_grads(arch, "sharded", atol_share=1e-6, moe_impl=impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradients(arch):
    P.check_remat_policies(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch):
    P.check_train_step(arch)
