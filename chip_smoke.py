"""Smoke test of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --chips 4   # four cards: the mesh path only

Phases, each checked byte for byte against python zlib or the input:

  1. device line (JAX version, device, card name and power limit)
  2. L2 encode of the 8 MiB mixed corpus (bench.make_corpus, seed 42)
     through compress() and compress_with_manifest()
  3. device decode of the phase-2 stream through its manifest, with no
     block falling back to the host decoder
  4. L3 encode of the bench's 1 MiB slice
  5. forced device decode of a foreign (zlib -9) stream on the wave path
  6. per-stage device times of the largest decode bucket, and 8 MiB
     decode_all end to end (no hand-written kernel remains to check
     against its XLA reference: see PERF.md)

Any failure exits non-zero.  The last line of standard output is a JSON
object naming the device; it is printed only when every phase passed.
Exits non-zero at once when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

NBLOCKS = 256                   # 8 MiB corpus
MESH_BLOCKS_PER_CARD = 256


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from JAX's own
    monitoring events, per thread (compiles run in the thread that
    triggers them)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self._by_thread = {}
        self._lock = threading.Lock()
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            with self._lock:
                t = threading.get_ident()
                self._by_thread[t] = self._by_thread.get(t, 0.0) + duration

    def mine(self) -> float:
        with self._lock:
            return self._by_thread.get(threading.get_ident(), 0.0)


def timed(clock: CompileClock, fn, *args, **kwargs):
    """(result, wall s, compile s) of one call, on this thread's clock."""
    import jax

    t0, c0 = time.perf_counter(), clock.mine()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0, clock.mine() - c0


@contextlib.contextmanager
def phase(name: str, clock: CompileClock):
    """Log a phase's wall and compile time."""
    t0, c0 = time.perf_counter(), clock.mine()
    yield
    log(f"[{name}] wall {time.perf_counter() - t0:.3f} s, compile "
        f"{clock.mine() - c0:.3f} s")


def warm_up(clock: CompileClock, tasks: dict) -> dict:
    """Run each phase's work once, concurrently, so that the programs
    compile in parallel; returns {name: (result, wall, compile)}."""
    with cf.ThreadPoolExecutor(max_workers=len(tasks)) as ex:
        futs = {k: ex.submit(timed, clock, *v) for k, v in tasks.items()}
        return {k: f.result() for k, f in futs.items()}


def steady_ms(fn, *args, reps: int = 10) -> float:
    """Median wall time of fn(*args) in ms, after one discarded warm-up;
    every call ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def device_line():
    """Print the device line; exit non-zero unless JAX's device is a GPU."""
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"jax {jax.__version__}; platform {d.platform}; device_kind "
        f"{d.device_kind}; count {len(devs)}")
    if d.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {d.platform}",
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {card}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def stage_pieces(calls):
    """Jitted pieces of the largest decode bucket (stage A; stages A+B and
    the within-chunk compaction; A-F), as {name: (fn, *args)}, for timing
    each stage on the card."""
    import jax

    from deflate_jax.models import wave_decoder as WD
    from deflate_jax.ops import wave as W

    _, (buf, off), W64, n, (ml, mdx) = max(calls, key=lambda c: c[2])

    def unpack(packed):
        packed = jax.lax.slice_in_dim(packed, off,
                                      off + WD._bucket_words(W64, n))
        return WD._unpack_bucket(packed, W64, n)

    @jax.jit
    def stage_a(packed):
        nw, _, _, md = unpack(packed)
        return W.decode_positions(nw, md, W64, ml, mdx)

    @jax.jit
    def stage_abc(packed):
        nw, hints, _, md = unpack(packed)
        A0, P1 = W.decode_positions(nw, md, W64, ml, mdx)
        sums, rank = W.chunk_automaton(A0, hints, W64)
        mk = W._unpack_marks(sums["Mlo"], sums["Mhi"], W64) > 0
        return W.chunk_compact(A0, P1, rank, mk), sums

    def stages_af(packed):
        return WD.wave_decode_packed(packed, W64, n, off=off, maxl=ml,
                                     maxd=mdx)

    return W64, n, {
        "A (per-position decode)": (stage_a, buf),
        "A+B+compaction": (stage_abc, buf),
        "A-F": (stages_af, buf)}


def run_one_card(device):
    import jax

    import bench
    import deflate_jax
    from deflate_jax.models import encoder as E
    from deflate_jax.models import wave_decoder as WD
    from deflate_jax.runtime import manifest as M
    from deflate_jax.utils.tables import BLOCK_SIZE

    clock = CompileClock()
    corpus = bench.make_corpus(np.random.default_rng(42),
                               NBLOCKS * BLOCK_SIZE)
    blocks = np.frombuffer(corpus, np.uint8).reshape(NBLOCKS, BLOCK_SIZE)
    l3_idx = np.concatenate([np.arange(8) + q * (NBLOCKS // 4)
                             for q in range(4)])
    piece = blocks[l3_idx].tobytes()
    foreign = zlib.compress(corpus, 9)[2:-4]

    def bucket(buf, W64, n, off, ml, mdx):
        return WD.fill_packed(*WD.wave_decode_packed(
            buf, W64, n, off=off, maxl=ml, maxd=mdx))

    # every phase's work once, concurrently, so that the programs compile
    # in parallel; the phases below then run them again, timed
    t0 = time.perf_counter()
    cold = warm_up(clock, {
        "compress L2": (deflate_jax.compress, corpus, 2),
        "manifest L2": (M.compress_with_manifest, corpus, 2),
        "compress L3": (deflate_jax.compress, piece, 3),
        "foreign decode": (functools.partial(
            deflate_jax.decompress, foreign, len(corpus), device=True,
            force_device=True),)})
    stream, man = cold["manifest L2"][0]
    _, calls = WD.prepare_bucketed(stream, [b[0] for b in man.blocks],
                                   [b[2] for b in man.blocks],
                                   man.hint_array())
    W64_max, n_max, pieces = stage_pieces(calls)
    cold.update(warm_up(clock, {
        **{f"decode bucket W64={W64}": (bucket, buf, W64, n, off, ml, mdx)
           for _, (buf, off), W64, n, (ml, mdx) in calls},
        **{f"stage {k}": v for k, v in pieces.items() if k != "A-F"}}))
    log(f"[0] warm-up: {time.perf_counter() - t0:.3f} s")
    for k, (_, w, c) in cold.items():
        log(f"[0] first run of {k}: wall {w:.3f} s, compile {c:.3f} s")
    deflate_jax.wave_fallback_count = 0

    with phase("2 L2 encode", clock):
        enc = deflate_jax.compress(corpus, 2)
        check(zlib.decompress(enc, -15) == corpus, "compress L2")
        stream, man = M.compress_with_manifest(corpus, 2)
        check(zlib.decompress(stream, -15) == corpus,
              "compress_with_manifest L2")
        log(f"[2] ratio {len(enc) / len(corpus):.6f} (compress), "
            f"{len(stream) / len(corpus):.6f} (with manifest)")
    B = deflate_jax._bucket(NBLOCKS)        # compress()'s batch size
    ma = E.encode_batch.lower(
        jax.numpy.asarray(blocks[:B]), np.full(B, BLOCK_SIZE, np.int32),
        np.ones(B, bool), np.int32(-1), 2, np.int32(0)).compile()
    log(f"[2] L2 encode program ({B} blocks) memory_analysis: "
        f"{ma.memory_analysis()}")

    with phase("3 device decode", clock):
        stats = {}
        out = M.decode_all(stream, man, device=True, stats=stats)
        check(out == corpus, "decode_all output")
        check(stats["path"] == "wave", f"decode_all path {stats}")
        check(stats["fallback_blocks"] == 0,
              f"host fallback blocks: {stats['fallback_blocks']}")
        log(f"[3] {stats}")
    _, (buf, off), W64, n, (ml, mdx) = max(calls, key=lambda c: c[2])
    ma = WD.wave_decode_packed.lower(buf, W64, n, off=off, maxl=ml,
                                     maxd=mdx).compile()
    log(f"[3] largest decode bucket (W64={W64}, {n} blocks) "
        f"memory_analysis: {ma.memory_analysis()}")

    with phase("4 L3 encode", clock):
        enc3 = deflate_jax.compress(piece, 3)
        check(zlib.decompress(enc3, -15) == piece, "compress L3")
        log(f"[4] ratio {len(enc3) / len(piece):.6f}")

    with phase("5 foreign decode", clock):
        stats = {}
        out = deflate_jax.decompress(foreign, len(corpus), device=True,
                                     force_device=True, stats=stats)
        check(out == corpus, "foreign decode output")
        check(stats["device_path"] == "wave", f"foreign path {stats}")
        check(deflate_jax.wave_fallback_count == 0,
              "wave fallback on the foreign stream")
        log(f"[5] device_path {stats['device_path']}, "
            f"wave_fallback_count {deflate_jax.wave_fallback_count}")
    with phase("6 decode stage times", clock):
        fn, buf = pieces["A-F"]
        pieces["G (match fill)"] = (WD.fill_packed, *fn(buf))
        for k, (fn, *args) in pieces.items():
            log(f"[6] largest bucket (W64={W64_max}, {n_max} blocks), "
                f"stage {k}: {steady_ms(fn, *args):.4f} ms")
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            check(M.decode_all(stream, man, device=True) == corpus,
                  "decode_all output")
            reps.append(time.perf_counter() - t0)
        log(f"[6] decode_all 8 MiB end to end: median "
            f"{1e3 * statistics.median(reps):.3f} ms over 5 runs "
            f"(min {1e3 * min(reps):.3f}, max {1e3 * max(reps):.3f})")
    return device


def run_four_cards(device):
    """compress_mesh / decompress_mesh over a 1-D mesh of four cards,
    against the single-device encoder and the corpus."""
    import jax
    import jax.numpy as jnp

    import bench
    from deflate_jax.models import encoder as E
    from deflate_jax.parallel import mesh as PM
    from deflate_jax.runtime import manifest as M
    from deflate_jax.runtime import stitch as S
    from deflate_jax.utils.tables import BLOCK_SIZE

    check(device["count"] == 4, f"--chips 4 needs 4 GPUs, JAX sees "
          f"{device['count']}")
    clock = CompileClock()
    nb = 4 * MESH_BLOCKS_PER_CARD
    corpus = bench.make_corpus(np.random.default_rng(42), nb * BLOCK_SIZE)
    mesh = PM.make_mesh(jax.devices()[:4])
    log(f"mesh: {mesh.devices.size} x {mesh.devices.reshape(-1)[0].device_kind}")

    blocks = np.frombuffer(corpus, np.uint8).reshape(nb, BLOCK_SIZE)

    def single_device():
        w1, t1 = E.encode_batch(
            jnp.asarray(blocks), jnp.full((nb,), BLOCK_SIZE, jnp.int32),
            jnp.ones((nb,), bool), jnp.int32(nb - 1), 2)
        return S.words_to_bytes(np.asarray(w1), int(t1))

    # the three encoders compile concurrently; mesh decode needs the
    # manifest first
    t0 = time.perf_counter()
    cold = warm_up(clock, {
        "mesh encode": (PM.compress_mesh, corpus, 2, mesh),
        "single-device encode": (single_device,),
        "manifest encode": (M.compress_with_manifest, corpus, 2)})
    stream, man = cold["manifest encode"][0]
    cold.update(warm_up(clock, {
        "mesh decode": (PM.decompress_mesh, stream, man, mesh)}))
    log(f"[0] warm-up: {time.perf_counter() - t0:.3f} s")
    for k, (_, w, c) in cold.items():
        log(f"[0] first run of {k}: wall {w:.3f} s, compile {c:.3f} s")

    with phase("mesh encode", clock):
        enc = PM.compress_mesh(corpus, 2, mesh=mesh)
        check(zlib.decompress(enc, -15) == corpus, "mesh encode (zlib)")
    with phase("single-device encode", clock):
        single = single_device()
    check(enc == single, "mesh encode bytes == single-device encode_batch")
    log(f"[mesh] encode bytes equal single-device encode_batch "
        f"({len(enc)} bytes)")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        PM.compress_mesh(corpus, 2, mesh=mesh)
        reps.append(time.perf_counter() - t0)
    log(f"[mesh] compress_mesh 32 MiB: median "
        f"{1e3 * statistics.median(reps):.3f} ms")

    with phase("mesh decode", clock):
        out = PM.decompress_mesh(stream, man, mesh)
        check(out == corpus, "mesh decode == corpus")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        PM.decompress_mesh(stream, man, mesh)
        reps.append(time.perf_counter() - t0)
    log(f"[mesh] decompress_mesh 32 MiB (wave path): median "
        f"{1e3 * statistics.median(reps):.3f} ms")
    return device


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    device = device_line()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.chips == 4:
        device = run_four_cards(device)
    else:
        device = run_one_card(device)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
