"""The forward kernels as ``torch.library`` custom ops.

A kernel launched through ``ctypes`` reads ``data_ptr()``, which a tracer
cannot follow: under ``torch.export`` the tensors are fake. So each
forward kernel that a model's forward reaches is registered as an op in
the ``climsim`` namespace, beside its wrapper:

* ``climsim::fused_bigru_heads_init_cm`` (B1), ``fused_bigru_heads_cm``
  (B4), ``fused_bigru_lbh`` (B7), ``fused_bigru_heads_lbh`` (B9) and
  ``fused_bigru_heads_init_lbh`` (B10) in ``pallas_rnn.py``;
* ``climsim::adding_sw_fast`` (B11) and ``lw_solver_noscat_fast`` (B12)
  in ``pallas_radiation.py``.

Each op's CPU implementation is the kernel's plain version, its CUDA
implementation launches the kernel (and counts the launch) or raises, and
its fake implementation gives the output shapes. The wrappers'
``torch.autograd.Function``s call the op in their forward and keep their
backward, so an exported program holds one ``torch.ops.climsim.*`` node
per kernel, and a process that loads it needs only these registrations
(``import climsim_tpu_torch.ops``), neither the model code nor its
parameters.

The other kernels (the stencils and the backward kernels) stay behind
their ``ctypes`` wrappers. Under an export every ``ctypes`` launch raises
(``_build.load`` calls ``refuse_export``), and so do the stencil wrappers
on any device, rather than bake their plain version into a graph.
"""
from __future__ import annotations

import torch

NAMESPACE = "climsim"


def fresh(outs, inputs) -> tuple:
    """``outs`` with every tensor that shares storage with an input or an
    earlier output cloned: an op's outputs may alias neither."""
    seen = {t.untyped_storage().data_ptr() for t in inputs
            if t.untyped_storage().nbytes()}
    res = []
    for t in outs:
        ptr = t.untyped_storage().data_ptr()
        if t.untyped_storage().nbytes() and ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        res.append(t)
    return tuple(res)


def refuse_export(name: str) -> None:
    """Raise when ``torch.export`` traces the ``ctypes`` wrapper ``name``:
    its launch cannot be traced, and its plain version would enter the
    graph in the kernel's place."""
    if torch.compiler.is_exporting():
        raise RuntimeError(
            f"{name} launches its kernel through ctypes and is not a "
            f"registered {NAMESPACE}:: op, so it cannot be exported")


def exported_ops(graph) -> list[str]:
    """The ``climsim::`` ops that an exported program's graph calls, one
    entry a node (e.g. ``["climsim.fused_bigru_lbh.default"]``)."""
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith(f"{NAMESPACE}.")]
