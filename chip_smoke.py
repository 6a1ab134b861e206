#!/usr/bin/env python3
"""Drive the PyTorch port's geoVI main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each, with its seconds):

1. require a CUDA device and print ``nvidia-smi``'s name and power limit;
2. build the distributor kernels (``nvcc``, at first use);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes in float64 and float32 (gather bit-exact; segment sum within
   1e-12 / 1e-5 of the per-bin sum of |cot|, and bitwise reproducible) and
   time both with CUDA events;
4. one 32^2 update on the CPU (plain versions) and on the card (kernels)
   from the same latents and host-drawn noise: final KL energies agree to
   1e-8 relative;
5. the 128^2 unbinned config (``bench.py``'s headline, ``residual_map=
   "vmap"``: the KL stage stacks the 8 samples): three updates;
6. the 4096^2 ``n_bins=128`` config with the sample loop (``smap``) for
   both stages: one update.

Phases 5 and 6 reset the kernels' launch counts just before the updates
and fail unless both kernels launched.  Any failure raises, so the exit
code is nonzero and no result line is printed.  The last two lines are a
JSON object of the kernels' numbers (float64, the main path's type) and
the device line.

    python3 chip_smoke.py --profile

adds, after phases 5 and 6, one more update of each config under
``torch.profiler``: the device's busy share and the costliest kernels.
"""

import json
import logging
import subprocess
import sys
import time

import torch

N_SAMPLES = 4  # antithetic pairs -> 8 posterior samples
NOISE_STD = 0.1
# bench.py's solver budgets
BENCH_KWARGS = dict(
    n_samples=N_SAMPLES,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=20))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=10, cg_kwargs=dict(maxiter=30))),
    sample_mode="nonlinear_resample",
)
# Short budgets for the CPU-vs-card comparison: CG on the ill-conditioned
# metric amplifies rounding differences (another FFT, another summation
# order) by orders of magnitude per iteration, so long solves are not
# comparable at 1e-8; five CG steps are.
SHORT_KWARGS = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)
SEGSUM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def phase(name):
    """Decorator printing one line per phase with its seconds."""

    def deco(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)
            return out

        return run

    return deco


def build_field(jt, dims, n_bins=None):
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    kw = {} if n_bins is None else dict(n_bins=n_bins)
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
        asperity=(5e-1, 5e-2), **kw,
    )
    return cfm.finalize()


def build_likelihood(jt, cf, device, key):
    """bench.py's `_build`: synthetic data from the prior plus white noise."""
    k1, k2 = jt.split(key, 2)
    cf = cf.to(device)
    with torch.no_grad():
        truth = cf(cf.init(k1, device=device))
        data = truth + NOISE_STD * jt.random_like(k2, truth)
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf)


def start(jt, lh, device, kwargs, key=7, pos_key=1, **maps):
    """bench.py's start: optimizer, state from key `key`, position from
    `pos_key`; `maps`: OptimizeVI's residual_map / kl_map."""
    opt = jt.OptimizeVI(lh, n_total_iterations=100, **maps)
    state = opt.init_state(key, **kwargs)
    samples = jt.Samples(
        pos=jt.random_like(pos_key, lh.domain, device=device), samples=None, keys=None
    )
    return opt, samples, state


def run_updates(jt, lh, device, n_updates, kwargs, key=7, pos_key=1, **maps):
    """`n_updates` updates from bench.py's start, each timed to a synchronize."""
    opt, samples, state = start(jt, lh, device, kwargs, key, pos_key, **maps)
    seconds = []
    for _ in range(n_updates):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, state = opt.update(samples, state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return samples, state, seconds


def cuda_ms(fn, n=50):
    """Mean milliseconds per call of `fn` over `n` calls, CUDA events."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


@phase("1 device")
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    # full float32 matrix products and convolutions wherever the port
    # runs on CUDA (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


@phase("2 build kernels")
def phase_build():
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops.cuda_build import BUILD_LOG

    t0 = time.perf_counter()
    bg._kernels()
    print(f"kernel build+load {time.perf_counter() - t0:.3f} s", flush=True)
    for name, (secs, log) in BUILD_LOG.items():
        print(f"nvcc {name}: {secs:.3f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)


@phase("3 kernels vs plain")
def phase_kernels(cases):
    """`cases`: {label: (BinIndex on the card, batch rows)}."""
    from nifty_tpu_torch.ops import bin_gather as bg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    for label, (dist, nrows) in cases.items():
        for dtype in (torch.float64, torch.float32):
            table = torch.randn((nrows, dist.nb), dtype=dtype, device=dev, generator=gen)
            cot = torch.randn((nrows, dist.n), dtype=dtype, device=dev, generator=gen)
            got = bg.bin_gather(table, dist)
            want = bg.bin_gather_plain(table, dist.idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bin_gather differs from its plain version ({label}, {dtype})")
            g_err = float((got - want).abs().max())

            s1 = bg.bin_segment_sum(cot, dist)
            s2 = bg.bin_segment_sum(cot, dist)
            plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
            scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
            torch.cuda.synchronize()
            if not torch.equal(s1, s2):
                raise AssertionError(f"bin_segment_sum is not reproducible ({label}, {dtype})")
            s_err = float((s1 - plain).abs().max())
            rel = float(((s1 - plain).abs() / scale.clamp_min(torch.finfo(dtype).tiny)).max())
            if rel > SEGSUM_RTOL[dtype]:
                raise AssertionError(
                    f"bin_segment_sum off by {rel:.3e} of sum|cot| ({label}, {dtype})"
                )
            times = dict(
                gather_ms=cuda_ms(lambda: bg.bin_gather(table, dist)),
                gather_plain_ms=cuda_ms(lambda: bg.bin_gather_plain(table, dist.idx)),
                segsum_ms=cuda_ms(lambda: bg.bin_segment_sum(cot, dist)),
                segsum_plain_ms=cuda_ms(
                    lambda: bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
                ),
            )
            key = (label, str(dtype).replace("torch.", ""))
            results[key] = dict(gather_err=g_err, segsum_err=s_err, segsum_rel=rel, **times)
            print(
                f"{label} {key[1]}: table ({nrows}, {dist.nb}) x map {dist.shape} | "
                f"gather {times['gather_ms']:.4f} ms (plain {times['gather_plain_ms']:.4f}) "
                f"| segment sum {times['segsum_ms']:.4f} ms "
                f"(plain {times['segsum_plain_ms']:.4f}) rel err {rel:.2e}",
                flush=True,
            )
    return results


@phase("4 32^2 update, CPU vs card")
def phase_cpu_vs_card(jt):
    energies = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        lh = build_likelihood(jt, build_field(jt, (32, 32)), dev, jt.HostKey(0))
        _, state, secs = run_updates(
            jt, lh, dev, 1, SHORT_KWARGS, key=jt.HostKey(7), pos_key=jt.HostKey(1)
        )
        energies[dev.type] = float(state.minimization_state.fun)
        print(f"32^2 on {dev.type}: KL energy {energies[dev.type]!r} in {secs[0]:.3f} s",
              flush=True)
    rel = abs(energies["cuda"] - energies["cpu"]) / abs(energies["cpu"])
    print(f"32^2 CPU vs card relative energy difference {rel:.3e}", flush=True)
    if not rel <= 1e-8:
        raise AssertionError(f"CPU and card disagree: relative {rel:.3e} > 1e-8")


def drive(jt, label, lh, n_updates, **maps):
    """Run the main path with the launch counts reset just before."""
    from nifty_tpu_torch.ops import bin_gather as bg

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    _, state, secs = run_updates(jt, lh, dev, n_updates, BENCH_KWARGS, **maps)
    counts = dict(gather=bg.bin_gather.launches, segsum=bg.bin_segment_sum.launches)
    energy = float(state.minimization_state.fun)
    med = sorted(secs)[len(secs) // 2]
    print(
        f"{label}: s/update {[round(s, 3) for s in secs]} median {med:.3f} | "
        f"geoVI samples/s {2 * N_SAMPLES / med:.4f} | KL energy {energy!r} | "
        f"launches gather {counts['gather']} segment_sum {counts['segsum']} | "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
        f"last KL Newton steps {state.minimization_state.nit}, geoVI steps per "
        f"sample {state.sample_state.nit.tolist()}",
        flush=True,
    )
    if not torch.isfinite(torch.tensor(energy)):
        raise AssertionError(f"{label}: non-finite KL energy {energy}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"{label}: a distributor kernel never launched: {counts}")
    return counts


def profile_update(jt, label, lh, top=12, **maps):
    """One warm-up update, then one under ``torch.profiler``: its wall time
    (inflated by the profiler), the summed device time of its kernels and
    the device's busy share, the kernel launches, the costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    opt, samples, state = start(jt, lh, dev, BENCH_KWARGS, **maps)
    samples, state = opt.update(samples, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        samples, state = opt.update(samples, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(evt):
        t = getattr(evt, "self_device_time_total", None)
        return evt.self_cuda_time_total if t is None else t

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(device_us(e) for e in kernels) / 1e6
    print(f"profile {label}: update {wall:.3f} s under the profiler | device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %) | "
          f"{sum(e.count for e in kernels)} kernel launches | "
          f"KL energy {float(state.minimization_state.fun)!r}", flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:100]}", flush=True)


def main(argv):
    """``--profile``: after phases 5 and 6, profile one more update of each
    config (device busy share and the costliest kernels)."""
    with_profile = "--profile" in argv
    phase_device()
    import nifty_tpu_torch as jt

    jt.logger.setLevel(logging.WARNING)
    phase_build()

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cf128 = build_field(jt, (128, 128)).to(dev)
    cf4096 = build_field(jt, (4096, 4096), n_bins=128).to(dev)
    print(f"field set-up (host mode maps, CSR) {time.perf_counter() - t0:.3f} s", flush=True)
    kres = phase_kernels({
        "4096^2 nb128 quarter B=1": (cf4096.dist, 1),
        "128^2 unbinned B=1": (cf128.dist, 1),
        "128^2 unbinned B=8": (cf128.dist, 8),
    })

    phase_cpu_vs_card(jt)

    lh128 = build_likelihood(jt, cf128, dev, 0)
    # bench.py's maps: 128^2 "vmap" (the KL stage stacks the samples),
    # 4096^2 the sample loop for both stages
    c128 = phase("5 128^2 unbinned, 3 updates")(drive)(
        jt, "128^2 unbinned", lh128, 3, residual_map="vmap")
    if with_profile:
        profile_update(jt, "128^2 unbinned", lh128, residual_map="vmap")
    del lh128
    lh4096 = build_likelihood(jt, cf4096, dev, 0)
    c4096 = phase("6 4096^2 n_bins=128, 1 update")(drive)(
        jt, "4096^2 n_bins=128", lh4096, 1, residual_map="smap", kl_map="smap")
    if with_profile:
        profile_update(jt, "4096^2 n_bins=128", lh4096, residual_map="smap", kl_map="smap")

    src = "nifty_tpu_torch/csrc/bin_gather.cu"
    tpu = "nifty_tpu/ops/pallas_gather.py"
    rows = [
        ("bin_gather", "K1", f"{tpu}:184", "4096^2 nb128 quarter B=1", "gather", c4096),
        ("bin_segment_sum", "K2", f"{tpu}:228", "4096^2 nb128 quarter B=1", "segsum", c4096),
        ("bin_gather", "K3", f"{tpu}:369", "128^2 unbinned B=8", "gather", c128),
        ("bin_segment_sum", "K4", f"{tpu}:406", "128^2 unbinned B=8", "segsum", c128),
    ]
    kernels = []
    for name, k, replaces, label, kind, counts in rows:
        r64 = kres[(label, "float64")]
        kernels.append(dict(
            name=f"{name} ({k}, {label}, float64)", route="cuda", source=src,
            replaces=replaces, launches=counts[kind], max_abs_err=r64[f"{kind}_err"],
            ms=r64[f"{kind}_ms"], plain_ms=r64[f"{kind}_plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
