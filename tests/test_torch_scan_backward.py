"""The scanned ``RNNLayer`` (the scan arm's and the physics scan trunk's
sweep) steps through its input projection with one ``unbind``, whose
backward is one stack, where it indexed ``xs_proj[:, l]`` a level at a
time, whose backward added a whole zero [B, L, 3H] gradient per level.
Its outputs and every gradient are the same bits as the indexing loop's,
kept here as the reference, in both directions and dtypes; and its graph
holds no per-level select."""
import pytest
import torch

from climsim_tpu_torch.models.cells import RNNLayer


class SelectRNNLayer(RNNLayer):
    """The earlier forward: a select of the projection per level."""

    def forward(self, xs, h0):
        xs_proj = self.input_proj(xs)
        h = h0.to(xs_proj.dtype)
        L = xs.shape[1]
        ys = [None] * L
        for l in (range(L - 1, -1, -1) if self.reverse else range(L)):
            h = self.cell(h, xs_proj[:, l])
            ys[l] = h
        return torch.stack(ys, dim=1), h


def _run(layer, x, h0):
    """Outputs, final carry and the gradients of a loss of both with
    respect to the input, the initial carry and every parameter."""
    x = x.clone().requires_grad_(True)
    h0 = h0.clone().requires_grad_(True)
    layer.zero_grad(set_to_none=True)
    ys, h = layer(x, h0)
    (ys.float().square().sum() + (h.float() * 3.0).sum()).backward()
    return [ys.detach(), h.detach(), x.grad, h0.grad] + \
        [p.grad.clone() for p in layer.parameters()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_unbind_sweep_is_bit_identical_to_the_select_loop(dtype, reverse):
    g = torch.Generator().manual_seed(3)
    layer = RNNLayer(7, 24, reverse=reverse, dtype=dtype, generator=g)
    x = torch.randn(5, 13, 7, generator=g)
    h0 = torch.randn(5, 24, generator=g)
    new = _run(layer, x, h0)
    layer.__class__ = SelectRNNLayer
    old = _run(layer, x, h0)
    assert len(new) == len(old) == 8
    for i, (a, b) in enumerate(zip(new, old)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def _grad_fns(root):
    seen, stack = set(), [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def test_sweep_graph_has_no_per_level_select():
    layer = RNNLayer(4, 8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 6, 4, requires_grad=True)
    ys, _ = layer(x, torch.zeros(3, 8))
    names = _grad_fns(ys.grad_fn)
    assert "UnbindBackward0" in names
    assert "SelectBackward0" not in names
    layer.__class__ = SelectRNNLayer
    ys, _ = layer(x, torch.zeros(3, 8))
    assert "SelectBackward0" in _grad_fns(ys.grad_fn)
