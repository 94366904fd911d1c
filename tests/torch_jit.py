"""JAX programs for the port's CPU tests, compiled at XLA's backend
optimization level 0: the same HLO as at the default level in about half
the compile time on the CPU, where calling JAX op by op compiles every
operation on its own."""
import jax
import jax.numpy as jnp

O0 = {"xla_backend_optimization_level": 0}


def jit_o0(f, *args):
    """``f(*args)`` through one jitted JAX program compiled at level 0."""
    args = jax.tree_util.tree_map(jnp.asarray, args)
    return jax.jit(f).lower(*args).compile(O0)(*args)
