"""C.2: ``RNNAutoreg.forward`` takes its TOA input (SOLIN and COSZRS,
surface columns 1 and 6) as the strided view ``x_sfc[:, 1:7:5]``, where
it indexed ``x_sfc[:, [1, 6]]``: the list became a host index tensor
copied to the device, which waits for the device, at every call. On the
CPU every arm's outputs are the same bits as with the list index, in
float32 and bfloat16, and the forward's aten calls hold no
``aten.index.Tensor``."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from climsim_tpu_torch.models import BF16, F32, RNNAutoreg

NX, NX_SFC, NY, NY_SFC, L, B = 6, 24, 6, 8, 8, 12
CM = dict(use_pallas=True, fuse_heads=True, level_major=True)
ARMS = {"v6": dict(CM, fuse_init=True), "v5": CM,
        "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True),
        "v3": dict(use_pallas=True, fuse_heads=True),
        "v2": dict(use_pallas=True), "scan": dict(),
        "scan_stochastic": dict(add_stochastic_layer=True,
                                ar_noise_rho=0.5)}


def _model(arm, policy):
    m = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC,
                   nneur=(16, 16), nh_mem=4, add_pres=True,
                   hyam=tuple(np.linspace(0.0, 0.01, L)),
                   hybm=tuple(np.linspace(0.0, 1.0, L)), sp_mean=9.8e4,
                   sp_div=1e3, policy=policy, device="cpu", **ARMS[arm])
    assert m.arm == arm.split("_")[0]
    return m


def _inputs(model, seed=4):
    g = torch.Generator().manual_seed(seed)
    lm = model.level_major
    xm = torch.randn((L, NX, B) if lm else (B, L, NX), generator=g)
    mem = 0.5 * torch.randn((L, 4, B) if lm else (B, L, 4), generator=g)
    return xm, torch.randn(B, NX_SFC, generator=g), mem


def _list_index(model):
    """The earlier TOA input, x_sfc[:, [1, 6]], put in place of the view
    by a pre-hook on mlp_toa1 (the same cast x_sfc)."""
    box = {}

    def hook(mod, args):
        return (box["x_sfc"][:, [1, 6]],)
    return box, model.mlp_toa1.register_forward_pre_hook(hook)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_toa_view_is_bit_equal_to_list_index(arm, policy):
    pol = {"F32": F32, "BF16": BF16}[policy]
    model = _model(arm, pol)
    xm, xs, mem = _inputs(model)
    kw = dict(deterministic=False,
              noise=torch.Generator().manual_seed(9)) \
        if arm == "scan_stochastic" else {}
    with torch.no_grad():
        new = model(xm, xs, mem, **kw)
        box, handle = _list_index(model)
        box["x_sfc"] = pol.cast_in(xs)
        try:
            if arm == "scan_stochastic":
                kw["noise"] = torch.Generator().manual_seed(9)
            old = model(xm, xs, mem, **kw)
        finally:
            handle.remove()
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


class AtenLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arm", list(ARMS))
def test_forward_has_no_index_tensor(arm):
    model = _model(arm, F32)
    xm, xs, mem = _inputs(model)
    kw = dict(deterministic=False, noise=torch.Generator().manual_seed(9)) \
        if arm == "scan_stochastic" else {}
    log = AtenLog()
    with torch.no_grad(), log:
        model(xm, xs, mem, **kw)
    assert torch.ops.aten.addmm.default in log.ops or \
        torch.ops.aten.mm.default in log.ops
    assert torch.ops.aten.index.Tensor not in log.ops
    # the list index, as the earlier forward wrote it, is what the log
    # catches
    log = AtenLog()
    with torch.no_grad(), log:
        xs[:, [1, 6]]
    assert torch.ops.aten.index.Tensor in log.ops
