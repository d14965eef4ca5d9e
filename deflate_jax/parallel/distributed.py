"""Multi-process (multi-host) distribution for the codec (SURVEY.md §5.8).

The reference is a single process (SURVEY.md §2.7); this module supplies
the framework's scale-out story: ``jax.distributed.initialize`` brings N
processes into one JAX runtime, the global mesh spans every process's
devices, and the data-parallel encode (parallel/mesh.py) runs unchanged —
its all_gather/psum collectives cross hosts as well as devices.  Blocks are independent (quirk Q5, deflate.hpp:697), so the only
cross-host traffic is the tiny per-block size vectors plus the final
psum of placed words.

On several hosts, call ``init()`` per process with the coordinator
address; for CI, the same code path runs as N processes x M
virtual CPU devices (tests/test_distributed.py), matching SURVEY.md §4's
multi-process CPU simulation mandate.
"""
from __future__ import annotations

import numpy as np


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_count: int | None = None) -> None:
    """Join this process to the distributed JAX runtime.

    Must be called before any other JAX API in the process.  On CPU, set
    ``local_device_count`` to simulate multiple devices per process.
    """
    import os

    if local_device_count is not None:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={local_device_count}")
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def global_mesh(axis: str = "data"):
    """1-D mesh over every device of every process."""
    import jax

    from deflate_jax.parallel import mesh as M

    return M.make_mesh(jax.devices(), axis)


def compress_distributed(data: bytes, level: int = 2, mesh=None) -> bytes:
    """Compress one buffer data-parallel over the global (multi-process)
    mesh.  Every process passes the SAME ``data``; the input is sharded
    block-wise over the global ``data`` axis, each process encodes only
    its addressable shard, and the finished bitstream (replicated by the
    final psum) is returned on every process.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deflate_jax.parallel import mesh as M
    from deflate_jax.runtime.stitch import words_to_bytes
    from deflate_jax.utils.tables import BLOCK_SIZE

    if mesh is None:
        mesh = global_mesh()
    ndev = mesh.devices.size
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    B = -(-nblocks // ndev) * ndev
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i in range(nblocks):
        chunk = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    live = np.arange(B) < nblocks

    def mk(arr, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    g_blocks = mk(blocks, P("data"))
    g_blens = mk(blens, P("data"))
    g_live = mk(live, P("data"))
    words, total = M.encode_mesh(
        g_blocks, g_blens, g_live, jnp.int32(nblocks - 1), level, mesh)
    # outputs are replicated (out_specs=P()), so every process holds a
    # full addressable copy
    words_np = np.asarray(jax.device_get(words))
    return words_to_bytes(words_np, int(total))
