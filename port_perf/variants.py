#!/usr/bin/env python3
"""Measure the design alternatives behind kernels B2 and B1 on one NVIDIA
card. Run from the repository root::

    python3 port_perf/variants.py

1. B2's first version (``port_perf/b2_first.cu``: one block per (b*h,
   16-row query tile), 8 serial 32-key tiles) at the serving shape (C=16
   rows against a 256-row lane, 8 heads, D=64, fp32, validity bias):
   device ms as built, without the bias read, without P.V and without
   QK^T, and clock64() cycles per phase of each tile of block (0, 0).
2. B1's candidate designs (``port_perf/b1_candidates.cu``), each checked
   bitwise against ``torch.add``, then timed against it in alternating
   pairs (add, candidate, candidate, add) at ResNet-50's residual-add
   shapes at batch 128: median device ms and median ratio.

Times are device time per launch from ``chip_smoke.device_ms`` (a CUDA
graph of back-to-back launches). Nothing here is part of the package.
"""

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bigdl_tpu_torch.ops import cuda_lib  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from chip_smoke import device_ms, nvidia_smi  # noqa: E402

HERE = Path(__file__).resolve().parent
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
B2_BUILDS = {"as built": [], "no bias read": ["-DNO_BIAS_READ"],
             "no P.V": ["-DNO_PV"], "no QK^T": ["-DNO_QK"],
             "stamps": ["-DSTAMPS"]}
B1_PAIRS = 5


def build(jobs):
    """{tag: (source, defines)} -> {tag: CDLL}, one nvcc each, in parallel,
    into the package's (gitignored) build directory."""
    out_dir = cuda_lib.BUILD_DIR / "port_perf"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, defs) in jobs.items():
        so = out_dir / f"{tag.replace(' ', '_').replace('^', '')}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defs, "-I",
               str(cuda_lib.CSRC), "-o", str(so), str(HERE / src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for tag, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def first_b2(lib, q, k, v, bias):
    fn = lib.bigdl_flash_attention_fwd
    fn.argtypes = [P, P, P, P, L, L, L, L, P, I, I, I, I, I, F, I, I, I, P]
    fn.restype = I
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    be = bias.expand(b, h, sq, sk)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), be.data_ptr(),
             *be.stride(), out.data_ptr(), b, h, sq, sk, d, d ** -0.5, 0, 0,
             0, stream())
    assert err == 0, err
    return out


def b2_phases(libs, card):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 8, 16, 64, generator=g, device="cuda")
    k, v = (torch.randn(1, 8, 256, 64, generator=g, device="cuda")
            for _ in range(2))
    bias = torch.where(torch.arange(256, device="cuda")[None, :]
                       <= torch.arange(16, device="cuda")[:, None], 0.0,
                       -1e9)[None, None]
    ref = fa.plain_attention(q, k, v, bias)
    for tag in ("as built", "no bias read", "no P.V", "no QK^T"):
        lib = libs[tag]
        err = (first_b2(lib, q, k, v, bias) - ref).abs().max().item()
        ms = device_ms(lambda: first_b2(lib, q, k, v, bias))
        print(f"[B2 first] {tag:12s}: {ms:.5f} ms (max_abs_err {err:.2e}) "
              f"on {card}", flush=True)
    lib = libs["stamps"]
    for _ in range(3):
        first_b2(lib, q, k, v, bias)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 128)()
    lib.old_b2_read_stamps.argtypes = [P]
    lib.old_b2_read_stamps(ctypes.cast(buf, P))
    s = list(buf)
    print(f"[B2 first] cycles, block (0,0) thread 0: before the tile loop "
          f"{s[1] - s[0]}; whole block {s[60] - s[0]}")
    prev = s[1]
    for t in range(8):
        a = s[2 + 6 * t:8 + 6 * t]
        print(f"[B2 first] tile {t}: registers->shared+sync "
              f"{a[1] - prev} next tile's loads {a[2] - a[1]} QK^T+bias "
              f"{a[3] - a[2]} row max {a[4] - a[3]} softmax+P.V "
              f"{a[5] - a[4]}", flush=True)
        prev = a[5]


def b1_candidates(lib, card):
    fn = lib.b1_run
    fn.argtypes = [I, P, P, P, L, I, I, P]
    fn.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def launcher(var, x, y, out):
        def call():
            err = fn(var, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                     x.numel(), codes[x.dtype], sms, stream())
            assert err == 0, (var, err)
        return call

    g = torch.Generator(device="cuda").manual_seed(3)
    for var in range(15):
        for dt in (torch.bfloat16, torch.float32):
            for n in ((1 << 20) + 3, 12845056):
                x, y = (torch.randn(n, generator=g, device="cuda").to(dt)
                        for _ in range(2))
                out = torch.empty_like(x)
                launcher(var, x, y, out)()
                torch.cuda.synchronize()
                assert torch.equal(out, x + y), (var, dt, n)
    print("[B1 candidates] all 15 bitwise equal to torch.add", flush=True)
    for dt, shape in ((torch.bfloat16, (128, 256, 56, 56)),
                      (torch.float32, (128, 256, 56, 56)),
                      (torch.bfloat16, (128, 512, 28, 28)),
                      (torch.bfloat16, (128, 2048, 7, 7))):
        x, y = (torch.randn(shape, generator=g, device="cuda").to(dt)
                for _ in range(2))
        out = torch.empty_like(x)
        bound = 3 * x.numel() * x.element_size() / 3.35e12 * 1e3
        for var in range(15):
            call = launcher(var, x, y, out)
            ratios, ks, adds = [], [], []
            for _ in range(B1_PAIRS):
                a1 = device_ms(lambda: torch.add(x, y, out=out))
                k1, k2 = device_ms(call), device_ms(call)
                a2 = device_ms(lambda: torch.add(x, y, out=out))
                ratios.append((k1 + k2) / (a1 + a2))
                ks += [k1, k2]
                adds += [a1, a2]
            ms = statistics.median(ks)
            print(f"[B1 candidates] {str(dt)[6:]} {shape} v{var:2d}: "
                  f"{ms:.5f} ms, torch.add {statistics.median(adds):.5f}, "
                  f"median ratio {statistics.median(ratios):.4f}, "
                  f"{bound / ms:.1%} of the byte bound on {card}",
                  flush=True)
        del x, y, out


def main():
    if not torch.cuda.is_available():
        print("variants.py runs on an NVIDIA card", file=sys.stderr)
        return 1
    card = nvidia_smi()
    t0 = time.monotonic()
    jobs = {tag: ("b2_first.cu", defs) for tag, defs in B2_BUILDS.items()}
    jobs["b1"] = ("b1_candidates.cu", [])
    libs = build(jobs)
    print(f"built {len(libs)} libraries in {time.monotonic() - t0:.1f} s",
          flush=True)
    b2_phases(libs, card)
    b1_candidates(libs["b1"], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
