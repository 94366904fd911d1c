"""Neural Circuit Policies: sparse NCP wirings + Closed-form
Continuous-time (CfC / liquid) cells (counterpart of
``climsim_tpu/models/ncp.py``).

Capability equivalent of the reference's vendored ncps library
(rnn/ncp.py: ``Wiring`` :24, ``NCP`` :299, ``AutoNCP`` :507, ``CfCCell``
:577, ``WiredCfCCell`` :710, ``LSTMCell`` :809, ``CfC`` :847; legacy,
not wired into the reference trainer, carried here for parity).

* Wirings are built host-side with numpy (the same RandomState call
  sequence as the reference, so the adjacency matrices are bit-identical
  for the same seed) and applied as constant 0/1 sparsity masks on dense
  kernels: a masked dense matmul beats any scatter at these sizes.
* Cells are ``nn.Module``s usable standalone or through :class:`CfC`,
  which mirrors the reference's module surface (mixed_memory LSTM, proj
  head, return_sequences, timespans) and steps the sequence with a
  Python loop. Every op is a plain torch operation, so ``torch.func``
  transforms (``vmap``, ``grad``) go through the whole model.
* Parameters keep flax's names and ``[in, out]`` kernel layout
  (``cell.backbone0.kernel``, ``cell.layer_0.ff1_kernel``,
  ``lstm.recurrent_map.kernel``, ``fc.bias``), so
  ``models.convert.from_flax_params`` loads a JAX tree as it is; the
  masks are buffers outside the ``state_dict``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resolve_device
from .cells import Dense


# --------------------------------------------------------------------------
# Wirings (host-side numpy; construction parity with rnn/ncp.py)
# --------------------------------------------------------------------------

class Wiring:
    """Sparse synapse bookkeeping: adjacency [units, units] and sensory
    adjacency [input_dim, units] with ±1 polarities (rnn/ncp.py:24-138)."""

    def __init__(self, units: int):
        self.units = units
        self.adjacency_matrix = np.zeros([units, units], dtype=np.int32)
        self.sensory_adjacency_matrix: Optional[np.ndarray] = None
        self.input_dim: Optional[int] = None
        self.output_dim: Optional[int] = None

    @property
    def num_layers(self) -> int:
        return 1

    def get_neurons_of_layer(self, layer_id: int):
        return list(range(self.units))

    def is_built(self) -> bool:
        return self.input_dim is not None

    def build(self, input_dim: int) -> None:
        if self.input_dim is not None and self.input_dim != input_dim:
            raise ValueError(
                f"Conflicting input dimensions: built with {self.input_dim}"
                f", got {input_dim}")
        if self.input_dim is None:
            self.set_input_dim(input_dim)

    def erev_initializer(self, shape=None, dtype=None) -> np.ndarray:
        return np.copy(self.adjacency_matrix)

    def sensory_erev_initializer(self, shape=None, dtype=None) -> np.ndarray:
        return np.copy(self.sensory_adjacency_matrix)

    def set_input_dim(self, input_dim: int) -> None:
        self.input_dim = input_dim
        self.sensory_adjacency_matrix = np.zeros(
            [input_dim, self.units], dtype=np.int32)

    def set_output_dim(self, output_dim: int) -> None:
        self.output_dim = output_dim

    def get_type_of_neuron(self, neuron_id: int) -> str:
        return "motor" if neuron_id < self.output_dim else "inter"

    def add_synapse(self, src: int, dest: int, polarity: int) -> None:
        if not (0 <= src < self.units and 0 <= dest < self.units):
            raise ValueError(f"synapse {src}->{dest} out of range "
                             f"(units={self.units})")
        if polarity not in (-1, 1):
            raise ValueError(f"polarity must be ±1, got {polarity}")
        self.adjacency_matrix[src, dest] = polarity

    def add_sensory_synapse(self, src: int, dest: int,
                            polarity: int) -> None:
        if self.input_dim is None:
            raise ValueError("call build() before adding sensory synapses")
        if not (0 <= src < self.input_dim and 0 <= dest < self.units):
            raise ValueError(f"sensory synapse {src}->{dest} out of range")
        if polarity not in (-1, 1):
            raise ValueError(f"polarity must be ±1, got {polarity}")
        self.sensory_adjacency_matrix[src, dest] = polarity

    @property
    def synapse_count(self) -> int:
        return int(np.sum(np.abs(self.adjacency_matrix)))

    @property
    def sensory_synapse_count(self) -> int:
        return int(np.sum(np.abs(self.sensory_adjacency_matrix)))

    def get_config(self) -> dict:
        return {
            "units": self.units,
            "adjacency_matrix": self.adjacency_matrix.tolist(),
            "sensory_adjacency_matrix":
                None if self.sensory_adjacency_matrix is None
                else self.sensory_adjacency_matrix.tolist(),
            "input_dim": self.input_dim,
            "output_dim": self.output_dim,
        }

    @classmethod
    def from_config(cls, config: dict) -> "Wiring":
        w = Wiring(config["units"])
        w.adjacency_matrix = np.array(config["adjacency_matrix"],
                                      dtype=np.int32)
        if config["sensory_adjacency_matrix"] is not None:
            w.sensory_adjacency_matrix = np.array(
                config["sensory_adjacency_matrix"], dtype=np.int32)
        w.input_dim = config["input_dim"]
        w.output_dim = config["output_dim"]
        return w


class NCP(Wiring):
    """4-layer sensory→inter→command→motor random sparse wiring
    (rnn/ncp.py:299-505). Same RandomState consumption order as the
    reference, so identical seeds give identical wirings."""

    def __init__(self, inter_neurons: int, command_neurons: int,
                 motor_neurons: int, sensory_fanout: int, inter_fanout: int,
                 recurrent_command_synapses: int, motor_fanin: int,
                 seed: int = 22222):
        super().__init__(inter_neurons + command_neurons + motor_neurons)
        self.set_output_dim(motor_neurons)
        self._rng = np.random.RandomState(seed)
        self._num_inter_neurons = inter_neurons
        self._num_command_neurons = command_neurons
        self._num_motor_neurons = motor_neurons
        self._sensory_fanout = sensory_fanout
        self._inter_fanout = inter_fanout
        self._recurrent_command_synapses = recurrent_command_synapses
        self._motor_fanin = motor_fanin

        # neuron IDs: [motor..., command..., inter...]
        self._motor_ids = list(range(motor_neurons))
        self._command_ids = list(range(motor_neurons,
                                       motor_neurons + command_neurons))
        self._inter_ids = list(range(
            motor_neurons + command_neurons,
            motor_neurons + command_neurons + inter_neurons))

        if motor_fanin > command_neurons:
            raise ValueError(f"motor_fanin {motor_fanin} > "
                             f"{command_neurons} command neurons")
        if sensory_fanout > inter_neurons:
            raise ValueError(f"sensory_fanout {sensory_fanout} > "
                             f"{inter_neurons} inter neurons")
        if inter_fanout > command_neurons:
            raise ValueError(f"inter_fanout {inter_fanout} > "
                             f"{command_neurons} command neurons")

    @property
    def num_layers(self) -> int:
        return 3

    def get_neurons_of_layer(self, layer_id: int):
        return [self._inter_ids, self._command_ids,
                self._motor_ids][layer_id]

    def get_type_of_neuron(self, neuron_id: int) -> str:
        if neuron_id < self._num_motor_neurons:
            return "motor"
        if neuron_id < self._num_motor_neurons + self._num_command_neurons:
            return "command"
        return "inter"

    def _connect_layer(self, srcs, dests, fanout, sensory: bool) -> None:
        """Fan each src out to `fanout` random dests, then reconnect any
        dest left unreached (ncp.py:393-446,455-479)."""
        add = self.add_sensory_synapse if sensory else self.add_synapse
        unreachable = list(dests)
        for src in srcs:
            for dest in self._rng.choice(dests, size=fanout, replace=False):
                if dest in unreachable:
                    unreachable.remove(dest)
                polarity = self._rng.choice([-1, 1])
                add(src, int(dest), int(polarity))
        mean_fanin = int(np.clip(len(srcs) * fanout / len(dests),
                                 1, len(srcs)))
        for dest in unreachable:
            for src in self._rng.choice(srcs, size=mean_fanin,
                                        replace=False):
                polarity = self._rng.choice([-1, 1])
                add(int(src), dest, int(polarity))

    def build(self, input_dim: int) -> None:
        super().build(input_dim)
        self._sensory_ids = list(range(self.input_dim))
        # sensory -> inter (reconnect clips fanin at num_sensory)
        self._connect_layer(self._sensory_ids, self._inter_ids,
                            self._sensory_fanout, sensory=True)
        # inter -> command. NOTE: the reference clips the reconnect fanin
        # at num_command (not num_inter; ncp.py:437-439) — reproduced.
        unreachable = list(self._command_ids)
        for src in self._inter_ids:
            for dest in self._rng.choice(self._command_ids,
                                         size=self._inter_fanout,
                                         replace=False):
                if dest in unreachable:
                    unreachable.remove(dest)
                polarity = self._rng.choice([-1, 1])
                self.add_synapse(src, int(dest), int(polarity))
        mean_fanin = int(np.clip(
            self._num_inter_neurons * self._inter_fanout
            / self._num_command_neurons, 1, self._num_command_neurons))
        for dest in unreachable:
            for src in self._rng.choice(self._inter_ids, size=mean_fanin,
                                        replace=False):
                polarity = self._rng.choice([-1, 1])
                self.add_synapse(int(src), dest, int(polarity))
        # recurrent command synapses
        for _ in range(self._recurrent_command_synapses):
            src = self._rng.choice(self._command_ids)
            dest = self._rng.choice(self._command_ids)
            polarity = self._rng.choice([-1, 1])
            self.add_synapse(int(src), int(dest), int(polarity))
        # command -> motor (fanin per motor; reconnect clips at num_motor)
        unreachable = list(self._command_ids)
        for dest in self._motor_ids:
            for src in self._rng.choice(self._command_ids,
                                        size=self._motor_fanin,
                                        replace=False):
                if src in unreachable:
                    unreachable.remove(src)
                polarity = self._rng.choice([-1, 1])
                self.add_synapse(int(src), dest, int(polarity))
        mean_fanout = int(np.clip(
            self._num_motor_neurons * self._motor_fanin
            / self._num_command_neurons, 1, self._num_motor_neurons))
        for src in unreachable:
            for dest in self._rng.choice(self._motor_ids, size=mean_fanout,
                                         replace=False):
                polarity = self._rng.choice([-1, 1])
                self.add_synapse(src, int(dest), int(polarity))


class AutoNCP(NCP):
    """NCP wiring derived from (units, output_size, sparsity_level)
    (rnn/ncp.py:507-564)."""

    def __init__(self, units: int, output_size: int,
                 sparsity_level: float = 0.5, seed: int = 22222):
        if output_size >= units - 2:
            raise ValueError("output_size must be < units-2")
        if sparsity_level < 0.1 or sparsity_level > 1.0:
            raise ValueError("sparsity_level must be in [0.1, 1.0]")
        density = 1.0 - sparsity_level
        inter_and_command = units - output_size
        command = max(int(0.4 * inter_and_command), 1)
        inter = inter_and_command - command
        super().__init__(
            inter, command, output_size,
            sensory_fanout=max(int(inter * density), 1),
            inter_fanout=max(int(command * density), 1),
            recurrent_command_synapses=max(int(command * density * 2), 1),
            motor_fanin=max(int(command * density), 1),
            seed=seed)


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------

def _lecun_tanh(x):
    return 1.7159 * torch.tanh(0.666 * x)


# flax's gelu is the tanh approximation
_ACTIVATIONS = {
    "lecun_tanh": _lecun_tanh,
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def _xavier_uniform(shape, generator: torch.Generator) -> nn.Parameter:
    """flax's ``xavier_uniform`` for a kernel [in, out]."""
    w = torch.empty(shape, dtype=torch.float32)
    with torch.no_grad():
        nn.init.xavier_uniform_(w, generator=generator)
    return nn.Parameter(w)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is 1 (torch's is 0): the
    pure mode's ``w_tau`` starts at 0 and would otherwise never move."""
    return torch.where(x >= 0, x, -x)


def _timespan(ts, like: torch.Tensor) -> torch.Tensor:
    """``ts`` (a scalar, [B] or [B, 1]) in ``like``'s dtype and device,
    a 1-D one as [B, 1]."""
    ts = torch.as_tensor(ts, dtype=like.dtype, device=like.device)
    return ts[:, None] if ts.ndim == 1 else ts


class CfCCell(nn.Module):
    """Closed-form Continuous-time cell (Hasani et al. 2021,
    arXiv:2106.13898; rnn/ncp.py:577-708). Modes: 'default' (gated
    interpolation), 'pure' (direct closed-form solution), 'no_gate'.

    ``sparsity_mask`` ([input_size + hidden_size, hidden_size]) applies the
    NCP wiring to the ff1/ff2 kernels as a constant 0/1 mask (a buffer
    outside the ``state_dict``); the masked kernels are then the cell's
    own parameters ``ff1_kernel``/``ff1_bias`` (xavier-uniform, zeros),
    as flax names them. Parameters live in float32; ``dtype`` is the
    compute dtype. ``device=None`` means ``"cuda"``; the weights come from
    ``generator``, or from ``seed`` without one."""

    def __init__(self, input_size: int, hidden_size: int,
                 mode: str = "default",
                 backbone_activation: str = "lecun_tanh",
                 backbone_units: int = 128, backbone_layers: int = 1,
                 sparsity_mask=None, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if mode not in ("default", "pure", "no_gate"):
            raise ValueError(f"unknown CfC mode {mode!r}")
        g = generator if generator is not None else \
            torch.Generator().manual_seed(seed)
        self.hidden_size, self.mode, self.dtype = hidden_size, mode, dtype
        self.backbone_activation = backbone_activation
        self.backbone_layers = backbone_layers
        nin = input_size + hidden_size
        for i in range(backbone_layers):
            setattr(self, f"backbone{i}",
                    Dense(nin if i == 0 else backbone_units, backbone_units,
                          dtype, g))
        if backbone_layers:
            nin = backbone_units
        self.masked = sparsity_mask is not None
        self.register_buffer(
            "sparsity_mask", None if sparsity_mask is None else
            torch.as_tensor(np.abs(np.asarray(sparsity_mask, np.float32))),
            persistent=False)
        heads = ("ff1",) if mode == "pure" else ("ff1", "ff2")
        for name in heads:
            if self.masked:
                setattr(self, f"{name}_kernel",
                        _xavier_uniform((nin, hidden_size), g))
                setattr(self, f"{name}_bias",
                        nn.Parameter(torch.zeros(hidden_size)))
            else:
                setattr(self, name, Dense(nin, hidden_size, dtype, g))
        if mode == "pure":
            self.w_tau = nn.Parameter(torch.zeros(1, hidden_size))
            self.A = nn.Parameter(torch.ones(1, hidden_size))
        else:
            self.time_a = Dense(nin, hidden_size, dtype, g)
            self.time_b = Dense(nin, hidden_size, dtype, g)
        self.to(resolve_device(device))

    def _head(self, x, name):
        if not self.masked:
            return getattr(self, name)(x)
        dt = self.dtype
        kernel = getattr(self, f"{name}_kernel").to(dt)
        bias = getattr(self, f"{name}_bias").to(dt)
        return x.to(dt) @ (kernel * self.sparsity_mask.to(dt)) + bias

    def forward(self, inputs, hx, ts=1.0):
        """inputs [B, nx], hx [B, H], ts scalar or [B]/[B, 1] timespan.
        Returns (output, new_hidden): both the new hidden state."""
        x = torch.cat([inputs, hx], dim=-1)
        act = _ACTIVATIONS[self.backbone_activation]
        for i in range(self.backbone_layers):
            x = act(getattr(self, f"backbone{i}")(x))
        ts = _timespan(ts, x)
        ff1 = self._head(x, "ff1")
        if self.mode == "pure":
            new_h = -self.A * torch.exp(
                -ts * (_abs(self.w_tau) + _abs(ff1))) * ff1 + self.A
        else:
            ff2 = torch.tanh(self._head(x, "ff2"))
            ff1 = torch.tanh(ff1)
            t_interp = torch.sigmoid(self.time_a(x) * ts + self.time_b(x))
            if self.mode == "no_gate":
                new_h = ff1 + t_interp * ff2
            else:
                new_h = ff1 * (1.0 - t_interp) + t_interp * ff2
        return new_h, new_h


class WiredCfCCell(nn.Module):
    """CfC cell over an NCP wiring: one masked CfCCell per wiring layer
    (``layer_{i}``), chained inter->command->motor (rnn/ncp.py:710-807).
    State is the concatenation of all layers' hiddens [B, wiring.units];
    output is the motor layer [B, output_dim]. A layer's input width is its
    mask's rows less its size."""

    def __init__(self, layer_sizes, layer_masks, output_dim: int,
                 mode: str = "default", dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else \
            torch.Generator().manual_seed(seed)
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        self.layer_masks = tuple(np.asarray(m, np.float32)
                                 for m in layer_masks)
        self.output_dim, self.mode = int(output_dim), mode
        dev = resolve_device(device)
        for i, (size, mask) in enumerate(zip(self.layer_sizes,
                                             self.layer_masks)):
            setattr(self, f"layer_{i}", CfCCell(
                mask.shape[0] - size, size, mode=mode, backbone_layers=0,
                sparsity_mask=mask, dtype=dtype, device=dev, generator=g))

    @classmethod
    def from_wiring(cls, wiring: Wiring, input_size: Optional[int] = None,
                    mode: str = "default", dtype: torch.dtype = torch.float32,
                    device=None, seed: int = 0,
                    generator: torch.Generator | None = None
                    ) -> "WiredCfCCell":
        return cls(*_wired_layers(wiring, input_size), mode=mode,
                   dtype=dtype, device=device, seed=seed,
                   generator=generator)

    @property
    def state_size(self) -> int:
        return sum(self.layer_sizes)

    def forward(self, inputs, hx, ts=1.0):
        h_states = torch.split(hx, list(self.layer_sizes), dim=-1)
        new_h = []
        h = inputs
        for i in range(len(self.layer_sizes)):
            h, _ = getattr(self, f"layer_{i}")(h, h_states[i], ts)
            new_h.append(h)
        return h, torch.cat(new_h, dim=-1)


def _wired_layers(wiring: Wiring, input_size: Optional[int]):
    """(layer sizes, layer masks, output dim) of a wiring, built at
    ``input_size`` if given: each mask the layer's |synapses| from the
    previous layer (the sensory inputs for the first) over a dense block
    for its own recurrence."""
    if input_size is not None:
        wiring.build(input_size)
    if not wiring.is_built():
        raise ValueError("wiring not built: pass input_size")
    sizes, masks = [], []
    for layer in range(wiring.num_layers):
        neurons = wiring.get_neurons_of_layer(layer)
        if layer == 0:
            in_sp = wiring.sensory_adjacency_matrix[:, neurons]
        else:
            prev = wiring.get_neurons_of_layer(layer - 1)
            in_sp = wiring.adjacency_matrix[:, neurons][prev, :]
        in_sp = np.concatenate(
            [in_sp, np.ones((len(neurons), len(neurons)))], axis=0)
        sizes.append(len(neurons))
        masks.append(np.abs(in_sp).astype(np.float32))
    return tuple(sizes), tuple(masks), int(wiring.output_dim)


class MixedMemoryLSTMCell(nn.Module):
    """The auxiliary LSTM of CfC(mixed_memory=True)
    (rnn/ncp.py:809-846): forget-gate bias +1, tanh cell output;
    ``input_map`` with a bias, ``recurrent_map`` without."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else \
            torch.Generator().manual_seed(seed)
        self.input_map = Dense(input_size, 4 * hidden_size, dtype, g)
        self.recurrent_map = Dense(hidden_size, 4 * hidden_size, dtype, g,
                                   use_bias=False)
        self.to(resolve_device(device))

    def forward(self, inputs, states):
        h, c = states
        z = self.input_map(inputs) + self.recurrent_map(h)
        i, ig, fg, og = z.chunk(4, dim=-1)
        new_c = c * torch.sigmoid(fg + 1.0) \
            + torch.tanh(i) * torch.sigmoid(ig)
        new_h = torch.tanh(new_c) * torch.sigmoid(og)
        return new_h, new_c


class CfC(nn.Module):
    """CfC sequence model (rnn/ncp.py:847-1010): dense or NCP-wired cell
    (``cell``), optional mixed LSTM memory (``lstm``) and projection head
    (``fc``), stepped over the sequence axis by a Python loop.

    ``wiring`` is (layer_sizes, layer_masks, output_dim, mode), as
    :meth:`wired` builds it from an NCP wiring. Call: ``(x [B, T, nx],
    hx=None, timespans=None)`` -> ``(outputs, final_state)`` where outputs
    is [B, T, out] if return_sequences else [B, out]; state is h or (h, c)
    with mixed_memory. ``device=None`` means ``"cuda"``; the weights come
    from one generator seeded with ``seed``."""

    def __init__(self, input_size: int, units: int, wiring=None,
                 proj_size: Optional[int] = None,
                 return_sequences: bool = True, mixed_memory: bool = False,
                 mode: str = "default", activation: str = "lecun_tanh",
                 backbone_units: int = 128, backbone_layers: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        dev = resolve_device(device)
        self.units, self.proj_size = units, proj_size
        self.return_sequences = return_sequences
        self.mixed_memory = mixed_memory
        if wiring is not None:
            sizes, masks, out_dim, wmode = wiring
            self.cell = WiredCfCCell(sizes, masks, out_dim, mode=wmode,
                                     dtype=dtype, device=dev, generator=g)
        else:
            out_dim = units
            self.cell = CfCCell(input_size, units, mode=mode,
                                backbone_activation=activation,
                                backbone_units=backbone_units,
                                backbone_layers=backbone_layers, dtype=dtype,
                                device=dev, generator=g)
        self.lstm = MixedMemoryLSTMCell(input_size, units, dtype=dtype,
                                        device=dev, generator=g) \
            if mixed_memory else None
        self.fc = Dense(out_dim, proj_size, dtype, g).to(dev) \
            if proj_size is not None else None

    @classmethod
    def wired(cls, wiring: Wiring, input_size: int, **kw) -> "CfC":
        """Construct from a (possibly unbuilt) NCP wiring."""
        sizes, masks, out_dim = _wired_layers(wiring, input_size)
        return cls(input_size, sum(sizes),
                   wiring=(sizes, masks, out_dim, kw.pop("mode", "default")),
                   **kw)

    @property
    def state_size(self) -> int:
        return self.units

    def forward(self, x, hx=None, timespans=None):
        B, T, _ = x.shape
        if hx is None:
            h = x.new_zeros((B, self.units))
            c = x.new_zeros((B, self.units if self.mixed_memory else 0))
        elif self.mixed_memory:
            h, c = hx
        else:
            h, c = hx, x.new_zeros((B, 0))
        ts = timespans if timespans is not None else x.new_ones((B, T))
        outs = []
        for t in range(T):
            x_t = x[:, t]
            if self.lstm is not None:
                h, c = self.lstm(x_t, (h, c))
            out, h = self.cell(x_t, h, ts[:, t])
            if self.fc is not None:
                out = self.fc(out)
            outs.append(out)
        final = (h, c) if self.mixed_memory else h
        if self.return_sequences:
            return torch.stack(outs, dim=1), final
        return outs[-1], final
