"""On-device autotuner for the serving pool and the offline chunk size.

The serving capacity of a pool depends on the stream-batch size B: a
larger batch amortizes each dispatch over more sessions until the
device saturates.  The offline pipeline's one device-specific knob is
the scan chunk size.  Both optima are properties of the hardware, so
this module packages the measurement protocol as a framework feature: a
deployment on new hardware re-derives its own optimum.

    from upmix.tune import tune_pool
    report = tune_pool(config, hw_block, batch_sizes=(256, 1024, 4096))
    best = report["best"]          # {"batch": ..., "streams_per_chip": ...}

or from the shell:

    python -m upmix.tune --sr 48000 --hw-block 2048 \
        --batches 256,1024,4096

Protocol notes:
- Candidates are visited ROUND-ROBIN and each keeps the MIN over
  visits: host and scheduler noise arrives in bursts, so sequential
  per-candidate timing misattributes a burst to whichever candidate it
  lands on.
- Each visit times `blocks` chained `push_blocks` calls with device-
  resident inputs (uploaded ONCE per candidate, outside the clock) and
  ONE tiny scalar fetch at the end: the pool's carried state
  dependency-chains the steps, so the fetch bounds the whole chain.
- A candidate that fails to build or compile (e.g. out of device
  memory) is recorded with its error and excluded from `best` — the
  tuner's job includes mapping the feasible region.
- The report carries `transport_floor_seconds` (min trivial
  dispatch+fetch time), the fixed per-dispatch cost every candidate
  pays.
- `protocol="scan"` runs each visit's `blocks` steps dependency-chained
  in ONE compiled program (make_sustained_runner) with a single scalar
  fetch: the device's sustained capacity without per-block host cost.
- `protocol="lockstep"` deliberately puts the transfers BACK in the
  timed region: host inputs in, a full host fetch of all three outputs
  per cycle — the stream server's lockstep dispatcher cycle
  (serve_stream.py), where outputs must reach client sockets before the
  next dispatch.  Size the sweep to the deployment's REAL stream count:
  each cycle moves ~5*B*hw*4 bytes.

`tune_offline` (CLI: `--offline`) applies the same protocol to the
offline pipeline's scan chunk size (models/offline.py CHUNK_SAMPLES):
`inner` applications dependency-chained in one dispatch per visit, min
over interleaved visits, best by realtime factor.

The reference has no analog (its one tunable, threshold_factor, is a
quality knob).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["tune_pool", "tune_offline"]


def tune_pool(
    config,
    hw_block: int,
    batch_sizes=(512, 1024, 2048, 4096),
    blocks: int = 16,
    visits: int = 3,
    protocol: str = "dispatch",
    unroll: int = 1,
    pipelines=(1,),
    verbose: bool = True,
) -> dict:
    """Sweep serving-pool batch sizes on the attached device; return
    per-candidate timings and the capacity-best choice.

    Capacity model: a pool serving B streams at `t` seconds per block
    sustains `B * (hw_block / sr) / t` realtime streams per chip.

    Three measurement protocols (``protocol=``):

    - ``"dispatch"`` (default): times the sustained `push_blocks` path
      — the deployment dispatch surface, donation and per-block host
      overhead included.
    - ``"scan"``: times `make_sustained_runner` — `blocks` steps
      dependency-chained inside ONE compiled program per visit, one
      scalar fetch at the end; `unroll` steps run per scan iteration.
      Host-side per-block costs are EXCLUDED — use "dispatch" to budget
      a deployment's end-to-end block cycle.
    - ``"lockstep"``: times the full serving cycle — HOST input arrays
      pushed, then all three outputs fetched to host before the next
      cycle, exactly the stream server's lockstep dispatcher
      (serve_stream.py: np.stack'd blocks in, np.asarray(c/ls/rs) out
      to the socket writers).

    ``pipelines`` sweeps the serving dispatcher's pipelined-dispatch
    depth (lockstep protocol only — the other protocols are already
    async-pipelined by jax dispatch): a candidate at pipeline=2 parks
    each cycle's device outputs and fetches them AFTER dispatching the
    next cycle, overlapping the host fetch with the device compute —
    StreamServer(pipeline=2)'s cost model.  Memory note: the scan
    protocol keeps one device-resident input slab alive per batch size
    for the interleaved visits (each slab is blocks*2*batch*hw_block*4
    bytes).  Returns::

        {"results": [...], "best": {...} | None,
         "protocol": {"blocks": ..., "visits": ...}}
    """
    import jax
    import jax.numpy as jnp

    from upmix.models.streaming import make_stream_pool

    hw_block = int(hw_block)
    block_seconds = hw_block / float(config.sr)
    if protocol not in ("dispatch", "scan", "lockstep"):
        raise ValueError(
            f"unknown protocol {protocol!r}; one of "
            "('dispatch', 'scan', 'lockstep')"
        )
    pipelines = tuple(int(p) for p in pipelines)
    if any(p not in (1, 2) for p in pipelines):
        raise ValueError(f"pipelines entries must be 1 or 2, got {pipelines}")
    if protocol != "lockstep" and pipelines != (1,):
        raise ValueError(
            "pipelines is a lockstep-protocol knob (the scan/dispatch "
            "protocols are already async-pipelined by jax dispatch); "
            f"got pipelines={pipelines} with protocol={protocol!r}"
        )

    built = []
    results = []
    # Pipeline variants time the SAME pool with a different fetch
    # schedule — share one build (and its compile) across them.
    pool_cache = {}  # batch -> (pool, xl, xr)
    for b in batch_sizes:
        for P in pipelines:
            b = int(b)
            label = f"B{b}" + (f"/P{P}" if P > 1 else "")
            rec = dict(batch=b, pipeline=P, label=label, ok=False,
                       error=None, seconds_per_block=None,
                       us_per_block_stream=None, streams_per_chip=None)
            results.append(rec)
            if b in pool_cache:
                rec["visits"] = []
                built.append((rec,) + pool_cache[b])
                continue
            try:
                pool = make_stream_pool(config, hw_block, b)
                if protocol == "scan":
                    run, fresh = pool.make_sustained_runner(blocks, unroll)
                    blk = jax.jit(
                        lambda k: jax.random.normal(
                            k, (blocks, 2, b, hw_block), jnp.float32
                        ) * 0.3
                    )(jax.random.PRNGKey(b))
                    # Warm: compile + one full chain off the clock.
                    _, cs = run(fresh(), blk)
                    float(np.asarray(cs[-1, 0, 0]))
                    entry = ((run, fresh), blk, None)
                else:
                    zl = jnp.zeros((b, hw_block), jnp.float32)
                    # Warm: trigger compile + first-dispatch costs off
                    # the clock; slice ON DEVICE before fetching.
                    pool.push_blocks(zl, zl)
                    c, _, _ = pool.push_blocks(zl, zl)
                    float(np.asarray(c[0, 0]))
                    if protocol == "lockstep":
                        # HOST inputs, deliberately: the lockstep serving
                        # cycle uploads np.stack'd socket blocks every
                        # dispatch, so the transfer is part of what this
                        # protocol measures.
                        rng = np.random.default_rng(b)
                        xh = (rng.standard_normal((2, b, hw_block)) * 0.3
                              ).astype(np.float32)
                    else:
                        # Device-resident inputs, built once: the
                        # dispatch protocol times the pool, not uploads.
                        xh = jax.jit(
                            lambda k: jax.random.normal(
                                k, (2, b, hw_block), jnp.float32
                            ) * 0.3
                        )(jax.random.PRNGKey(b))
                        jax.block_until_ready(xh)
                    entry = (pool, xh[0], xh[1])
            except Exception as e:  # build or compile rejection
                rec["error"] = f"{type(e).__name__}: {e}"
                if verbose:
                    print(f"tune: {label}: FAILED ({type(e).__name__})",
                          flush=True)
                continue
            pool_cache[b] = entry
            rec["visits"] = []
            built.append((rec,) + entry)

    # Transport floor: the cheapest possible dispatch+fetch round trip,
    # reported alongside the candidates as the fixed per-dispatch cost.
    transport_floor = None
    if built:
        tiny = jax.jit(lambda a: a + 1.0)
        dev = jnp.zeros(())
        float(np.asarray(tiny(dev)))  # compile off the clock
        floors = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(np.asarray(tiny(dev)))
            floors.append(time.perf_counter() - t0)
        transport_floor = min(floors)

    for v in range(int(visits)):
        for rec, pool, xl, xr in built:
            if protocol == "scan":
                run, fresh = pool
                st = fresh()  # state allocation outside the timed region
                t0 = time.perf_counter()
                _, cs = run(st, xl)
                float(np.asarray(cs[-1, 0, 0]))  # bound the whole chain
            elif protocol == "lockstep":
                pending = None
                t0 = time.perf_counter()
                for _ in range(int(blocks)):
                    # Full host round trip per cycle ON PURPOSE: the
                    # serving dispatcher can't issue the next cycle
                    # until this one's outputs are on their way to the
                    # sockets.  pipeline=2 parks each cycle's device
                    # outputs and fetches them after dispatching the
                    # NEXT cycle (StreamServer(pipeline=2)'s schedule).
                    out = pool.push_blocks(xl, xr)
                    if rec["pipeline"] > 1:
                        out, pending = pending, out
                    for o in out or ():
                        np.asarray(o)
                for o in pending or ():
                    np.asarray(o)
            else:
                t0 = time.perf_counter()
                out = None
                for _ in range(int(blocks)):
                    out = pool.push_blocks(xl, xr)
                # Bound the chained steps with a DEVICE-SLICED scalar
                # fetch (fetching the whole C block would add a transfer
                # to the timed region).
                float(np.asarray(out[0][0, 0]))
            dt = (time.perf_counter() - t0) / int(blocks)
            rec["visits"].append(dt)
            if verbose:
                print(f"tune: visit {v} {rec['label']:>10s}: "
                      f"{dt * 1e3:8.3f} ms/block", flush=True)

    best = None
    for rec in results:
        if rec.get("visits"):
            t = min(rec["visits"])
            rec["ok"] = True
            rec["seconds_per_block"] = t
            rec["us_per_block_stream"] = t / rec["batch"] * 1e6
            rec["streams_per_chip"] = rec["batch"] * block_seconds / t
            if best is None or rec["streams_per_chip"] > best["streams_per_chip"]:
                best = rec
        rec.pop("visits", None)

    if verbose and transport_floor is not None:
        print(f"tune: transport floor {transport_floor * 1e3:.2f} ms "
              f"(trivial dispatch+fetch)", flush=True)
    if verbose and best is not None:
        print(f"tune: best {best['label']}: "
              f"{best['streams_per_chip']:.0f} realtime streams/chip "
              f"({best['us_per_block_stream']:.2f} us/block/stream)",
              flush=True)
    return {
        "results": results,
        "best": best,
        "protocol": {"name": protocol, "blocks": int(blocks),
                     "visits": int(visits),
                     "unroll": int(unroll) if protocol == "scan" else None,
                     "pipelines": list(pipelines),
                     "estimator": "min-of-visits, interleaved",
                     "transport_floor_seconds": transport_floor},
    }


def tune_offline(
    config=None,
    *,
    sr: float = 44100.0,
    band_edges=(0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0),
    max_block_size: int = 2**16,
    n_samples: int = 2**21,
    chunks=(2**19, 2**20, 2**21, 2**22),
    kernel: str = "auto",
    inner: int = 6,
    visits: int = 3,
    verbose: bool = True,
) -> dict:
    """Autotune the offline pipeline's chunk size for the attached device.

    The offline scan's chunk size trades scan-step count against working-
    set size (models/offline.py CHUNK_SAMPLES is the default).  Each
    candidate builds build_offline_fn(config, n_samples, chunk=c) and
    times `inner` applications dependency-chained inside ONE jitted
    dispatch (a scalar of each output seeds the next input, so the
    runtime cannot overlap them), interleaved round-robin with
    min-of-visits — the same burst-noise discipline as tune_pool.
    chunk=0 means one whole-file program (no scan).

    Returns {"results": [...], "best": {...}, "protocol": {...}} with
    per-candidate seconds_per_application and realtime_factor
    (audio-seconds per wall-second, bench.py's headline metric).
    """
    import jax
    import jax.numpy as jnp

    from upmix.config import UpmixConfig
    from upmix.models.offline import build_offline_fn

    if config is None:
        config = UpmixConfig.make(
            list(band_edges), sr=sr, max_block_size=max_block_size
        )
    if inner < 1 or visits < 1:
        raise ValueError("inner and visits must be >= 1")

    # Chunking only exists on the 'mm' scan kernel with pow2/divisible
    # band geometry (build_offline_fn's gates).  When inactive, every
    # chunk candidate builds the IDENTICAL whole-file program — ranking
    # noise between copies of one program is not a sweep, so build one
    # candidate and record the rest as duplicates (no silent caps).
    from upmix.models.offline import resolve_kernel

    try:
        kern = resolve_kernel(kernel)
    except ValueError:
        kern = None  # unknown kernel: every candidate records the error
    chunk_active = (
        kern == "mm"
        and all(b.block_size % b.hop_size == 0 for b in config.bands)
        and all(b.block_size & (b.block_size - 1) == 0 for b in config.bands)
    )
    if not chunk_active and verbose:
        print(
            f"tune: WARNING — chunking is inactive here (kernel resolves "
            f"to {kern!r} / geometry not pow2-divisible): every candidate "
            "is the same whole-file program; building one",
            flush=True,
        )

    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.standard_normal(n_samples), jnp.float32)
    R = jnp.asarray(rng.standard_normal(n_samples), jnp.float32)
    L, R = jax.device_put((L, R))
    jax.block_until_ready((L, R))

    results = []
    built = []
    first_label = None
    clamped_label = None
    for c in chunks:
        c = int(c)
        label = "whole" if c == 0 else f"chunk={c}"
        rec = {"chunk": c, "label": label, "ok": False}
        results.append(rec)
        if not chunk_active and first_label is not None:
            rec["error"] = (
                f"chunking inactive — identical program to {first_label}"
            )
            continue
        if chunk_active and c >= n_samples and c > 0:
            # The builder clamps any chunk >= the input to "whole input,
            # one scan step" — only the first such candidate is distinct.
            if clamped_label is not None:
                rec["error"] = (
                    f"clamps to the input length — duplicate of "
                    f"{clamped_label}"
                )
                continue
            clamped_label = label
        try:
            base = build_offline_fn(config, n_samples, kernel=kernel, chunk=c)

            def step(L, R, seed, base=base):
                for _ in range(inner):
                    cc, _ls, _rs = base(L + seed, R - seed)
                    seed = cc[0] * 1e-6
                return seed

            fn = jax.jit(step)
            seed = jnp.zeros((), jnp.float32)
            float(np.asarray(fn(L, R, seed)))  # compile + warm off the clock
        except Exception as e:  # infeasible candidate: record, keep going
            rec["error"] = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"tune: {label} infeasible: {rec['error']}", flush=True)
            continue
        rec["visits"] = []
        built.append((rec, fn))
        if first_label is None:
            first_label = label

    for _v in range(int(visits)):
        for rec, fn in built:
            seed = jnp.zeros((), jnp.float32)
            t0 = time.perf_counter()
            float(np.asarray(fn(L, R, seed)))
            rec["visits"].append((time.perf_counter() - t0) / int(inner))

    audio_seconds = n_samples / float(config.sr)
    best = None
    for rec in results:
        if rec.get("visits"):
            t = min(rec["visits"])
            rec["ok"] = True
            rec["seconds_per_application"] = t
            rec["realtime_factor"] = audio_seconds / t
            if best is None or rec["realtime_factor"] > best["realtime_factor"]:
                best = rec
        rec.pop("visits", None)
        if verbose and rec["ok"]:
            print(f"tune: {rec['label']}: {rec['realtime_factor']:.0f}x "
                  f"realtime ({rec['seconds_per_application'] * 1e3:.2f} ms "
                  f"per {audio_seconds:.1f} s of audio)", flush=True)
    if verbose and best is not None:
        print(f"tune: best {best['label']}: "
              f"{best['realtime_factor']:.0f}x realtime", flush=True)
    return {
        "results": results,
        "best": best,
        "protocol": {"name": "offline", "n_samples": int(n_samples),
                     "inner": int(inner), "visits": int(visits),
                     "kernel": kernel, "chunk_active": chunk_active,
                     "estimator": "min-of-visits, interleaved"},
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="autotune the serving pool's batch size — or, with "
        "--offline, the offline pipeline's chunk size — for the attached "
        "device"
    )
    ap.add_argument("--offline", action="store_true",
                    help="tune the offline pipeline's scan chunk size "
                    "instead of the serving pool (--chunks/--samples/"
                    "--inner; --sr defaults to 44100 and --edges to the "
                    "reference offline config in this mode)")
    ap.add_argument("--chunks", default="524288,1048576,2097152,4194304",
                    help="offline mode: chunk sizes to sweep, comma-"
                    "separated (0 = one whole-file program)")
    ap.add_argument("--samples", type=int, default=2**21,
                    help="offline mode: input length per application")
    ap.add_argument("--inner", type=int, default=6,
                    help="offline mode: applications chained per timed "
                    "dispatch")
    ap.add_argument("--kernel", default="auto",
                    help="offline mode: transform kernel (auto/mm/xla)")
    ap.add_argument("--max-block-size", type=int, default=2**16,
                    help="offline mode: per-band STFT size cap")
    ap.add_argument("--sr", type=float, default=None)
    ap.add_argument("--hw-block", type=int, default=2048)
    ap.add_argument("--edges", default=None,
                    help="band edges in Hz, comma-separated (default: "
                    "0,500,2000,8000 for the pool; the reference "
                    "offline 6-band config with --offline)")
    ap.add_argument("--batches", default="512,1024,2048,4096")
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--visits", type=int, default=3)
    ap.add_argument("--protocol", default="dispatch",
                    choices=("dispatch", "scan", "lockstep"),
                    help="dispatch = sustained push_blocks (async-"
                    "pipelined dispatch surface); scan = one-dispatch "
                    "chained steps (device-side capacity); lockstep = "
                    "full serving cycle incl. host input upload + "
                    "3-output fetch (the stream-server dispatcher's cost "
                    "model)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="scan protocol: steps per scan iteration")
    ap.add_argument("--pipelines", default="1",
                    help="pipelined-dispatch depths to sweep, comma-"
                    "separated (lockstep protocol only; 2 = fetch each "
                    "cycle's outputs after dispatching the next, "
                    "overlapping host fetch with chip compute)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as one JSON line")
    args = ap.parse_args(argv)

    from upmix.config import UpmixConfig
    from upmix.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.offline:
        report = tune_offline(
            sr=args.sr if args.sr is not None else 44100.0,
            band_edges=[
                float(e)
                for e in (args.edges or "0,30,120,480,1920,7680").split(",")
            ],
            max_block_size=args.max_block_size,
            n_samples=args.samples,
            chunks=[int(c) for c in args.chunks.split(",")],
            kernel=args.kernel,
            inner=args.inner,
            visits=args.visits,
            verbose=not args.json,
        )
        if args.json:
            print(json.dumps(report))
        elif report["best"] is None:
            print("tune: no candidate compiled", flush=True)
        return 0 if report["best"] is not None else 1
    config = UpmixConfig.streaming(
        [float(e) for e in (args.edges or "0,500,2000,8000").split(",")],
        sr=args.sr if args.sr is not None else 48000.0, hw_block_size=args.hw_block,
    )
    report = tune_pool(
        config, args.hw_block,
        batch_sizes=[int(b) for b in args.batches.split(",")],
        blocks=args.blocks, visits=args.visits, protocol=args.protocol,
        unroll=args.unroll,
        pipelines=[int(p) for p in args.pipelines.split(",")],
        verbose=not args.json,
    )
    if args.json:
        print(json.dumps(report))
    elif report["best"] is None:
        print("tune: no candidate compiled", flush=True)
    # A sweep where every candidate failed is a failure regardless of
    # the output format — scripted (--json) runs must see exit 1 too.
    return 0 if report["best"] is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
