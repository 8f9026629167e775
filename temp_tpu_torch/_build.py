"""Builds and loads the package's CUDA kernels: the one place that does.

Every ``csrc/*.cu`` source (with the headers it includes, ``csrc/*.cuh``)
compiles in its own ``nvcc`` process, all started together, and one more
``nvcc`` links the objects into a shared library with a plain C interface
(``.kernel_build/libtemp_kernels.so`` at the root of the checkout), loaded
with ``ctypes``. No PyTorch headers are compiled, so the build takes
seconds. It happens at first use and again whenever a source or header is
newer than the library. Each exported launcher takes raw device pointers,
sizes and the CUDA stream, and returns ``cudaGetLastError()``. The
``*_bf16.cu`` sources give the kernels' bfloat16 modes, their launchers
``name_bf16`` with ``name``'s arguments (``BF16_LAUNCHERS``): most compile
a kernel source again in that mode; ``fused_window_bf16.cu`` has the
window's own native bfloat16 kernels (``csrc/window_bf16.cuh``),
``fused_final_bf16.cu`` K3's layer launch and K5's beside its source's
bfloat16 compile (K3's score launch and K4), and ``fused_final_bi_bf16.cu``
K6+K7's and K9+K10's (with ``final_bf16_occupancy`` and
``bi_bf16_occupancy``, which exist in bfloat16 only); ``ring_spmm_bf16.cu``
adds the ring SpMM's whole-card route, which exists in bfloat16 only
(``ring_bf16_*``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
BUILD_DIR = os.path.join(_ROOT, ".kernel_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtemp_kernels.so")
NVCC_TIMEOUT_S = 120

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# launcher name -> argtypes (pointers and the stream as c_void_p, so ctypes
# never cuts a 64-bit address to 32 bits)
SIGNATURES = {
    # spmm_fwd(ptr, edge, tpos, n_times, mask, h, w, out, n2_out, B, n,
    #          rows, cap, d, vec, h_bf16, onehot, stream)
    "spmm_fwd_launch": [_P, _P, _P, _I] + [_P] * 5 + [_I] * 8 + [_P],
    # ring_fwd_step(ptr, edge, tpos, tpos_stride, n_times, mask,
    #               mask_stride, rank_ids, out_ids, h_visit, w, out, n2_out,
    #               B, nc, n_out, m, rows, cap, d, s, k, first, last, stream)
    "ring_fwd_step_launch": [_P, _P, _P, _L, _I, _P, _L] + [_P] * 6
                            + [_I] * 11 + [_P],
    # ring_bwd_step(ptr, edge, tpos, tpos_stride, n_times, mask,
    #               mask_stride, rank_ids, out_ids, g, n2, w, acc_in,
    #               acc_out, B, nc, n_out, m, rows, cap, d, s, k, stream)
    "ring_bwd_step_launch": [_P, _P, _P, _L, _I, _P, _L] + [_P] * 7
                            + [_I] * 9 + [_P],
    # ring_dw(ptr, edge, tpos, tpos_stride, n_times, mask, mask_stride,
    #         rank_ids, out_ids, g, n2, h, part, B, nc, m, rows, cap,
    #         n_rels, d, s, stream)
    "ring_dw_launch": [_P, _P, _P, _L, _I, _P, _L] + [_P] * 6 + [_I] * 8
                      + [_P],
    # ring_dw_reduce(part, out, n_part, total, stream)
    "ring_dw_reduce_launch": [_P, _P, _I, _L, _P],
    # ring_bf16_fwd(ptr, edge, tpos, tpos_stride, n_times, mask,
    #               mask_stride, h, w, out, n2_out, B, m, rows, cap, d, s,
    #               vec, stream): K13 bf16's whole-card route
    "ring_bf16_fwd_launch": [_P, _P, _P, _L, _I, _P, _L] + [_P] * 4
                            + [_I] * 7 + [_P],
    # ring_bf16_bwd(s_ptr, s_edge, r_ptr, r_edge, tpos, tpos_stride,
    #               n_times, mask, mask_stride, g, n2, h, w, dh, dw, B, m,
    #               rows, cap, n_rels, d, s, vec, stream): K13b bf16's
    "ring_bf16_bwd_launch": [_P] * 5 + [_L, _I, _P, _L] + [_P] * 6
                            + [_I] * 8 + [_P],
    # ring_bf16_occupancy(which, B, m, rows, n_rels, d, s, vec, out): the
    #               whole-card kernel `which` (0 forward, 1 backward) as its
    #               launcher launches it -> out[5] (blocks of the grid,
    #               registers a thread, threads a block, resident blocks an
    #               SM, local bytes a thread), a host int[5]
    "ring_bf16_occupancy": [_I] * 8 + [_P],
    # spmm_bwd(s_ptr, s_edge, r_ptr, r_edge, tpos, n_times, mask, g, n2, h,
    #          w, dh, dw, B, n, rows, cap, n_rels, d, vec, h_bf16, onehot,
    #          stream)
    "spmm_bwd_launch": [_P] * 5 + [_I] + [_P] * 7 + [_I] * 9 + [_P],
    # window_layer(x, conv_given, rowptr, src, rel, em, wrel, wstride, wcol,
    #              loop, mask, relu, wih_t, whh_t, bih, bhh, gidx, live, dt,
    #              lam, buf, loc, B, L1, A, d, x_bf16, k, stream)
    "window_layer_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I,
                            _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P,
                            _P, _I, _I, _I, _I, _I, _I, _P],
    # window_bwd_gru(x, rowptr, src, rel, em, wrel, wstride, wcol, loop,
    #                mask, relu, wih_t, whh_t, bih, bhh, wih, whh, gidx, live,
    #                dt, lam, prev, db, g_loc, n2_out, conv_s, h0g_s, dgi_s,
    #                dgh_s, dconv_s, dlp_s, B, L1, A, d, k, stream)
    "window_bwd_gru_launch": [_P, _P, _P, _P, _P, _P, _I, _I,
                              _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
    # window_bwd_input(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s,
    #                  wrel, wstride, wcol, loop_t, x, ewg, out, accumulate,
    #                  B, L1, A, d, k, stream)
    "window_bwd_input_launch": [_P] * 9 + [_I, _I, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _P],
    # window_wgrad(conv2, h0g2, buf1, dgi2, dgh2, dlp2, conv1, h0g1, h0x,
    #              dgi1, dgh1, dlp1, part, n_split, B, L1, A, d, k, stream)
    "window_wgrad_launch": [_P] * 13 + [_I, _I, _I, _I, _I, _I, _P],
    # window_wgrad_reduce(part, n_split, total, out, stream)
    "window_wgrad_reduce_launch": [_P, _I, ctypes.c_longlong, _P, _P],
    # window_rel_grad(r_ptr, r_eid, ewg1, ewg2, dwrel, n_rels, d, stream)
    "window_rel_grad_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    # window_occupancy(which, d, out): kernel `which` of the window (0 K2f,
    #                  1 K2b's GRU tile, 2 its input tile, 3 its weight
    #                  launch) at width d -> out[3] (shared memory bytes a
    #                  block, threads, resident blocks an SM), a host int[3]
    "window_occupancy": [_I, _I, _P],
    # final_layer(x, rowptr, src, rel, em, wrel, wstride, wcol, loop, mask,
    #             wih_t, whh_t, bih, bhh, dt, lam, prev, sel_x, active, out,
    #             B, N, d, stream); in the bfloat16 mode x, loop, wih_t,
    #             whh_t and prev bfloat16
    "final_layer_launch": [_P] * 6 + [_I, _I] + [_P] * 7 + [_F]
                          + [_P] * 4 + [_I, _I, _I, _P],
    # final_scores(table, rtab, src, dst, rel, posm, t_ptr, t_ans, h_ptr,
    #              h_ans, part_m, part_s, qhat, scpos, B, N, E, d, n_split,
    #              stream)
    "final_scores_launch": [_P] * 14 + [_I] * 5 + [_P],
    # final_loss_reduce(part_m, part_s, scpos, posm, lse, cnt, loss, B, E,
    #                   n_split, stream)
    "final_loss_reduce_launch": [_P] * 7 + [_I] * 3 + [_P],
    # final_dq(table, qhat, lse, posm, t_ptr, t_ans, h_ptr, h_ans, cnt, gout,
    #          part_dq, B, N, E, d, n_split, stream)
    "final_dq_launch": [_P] * 11 + [_I] * 5 + [_P],
    # final_dq_finish(table, rtab, src, dst, rel, posm, qhat, scpos, lse,
    #                 cnt, g, part_dq, d_s, d_o, d_remb, B, N, E, d,
    #                 n_split, stream)
    "final_dq_finish_launch": [_P] * 15 + [_I] * 5 + [_P],
    # final_dtable(table, qhat, lse, posm, cnt, g, src, dst, t_ptr, t_ans,
    #              h_ptr, h_ans, d_s, d_o, d_table, B, N, E, d, stream)
    "final_dtable_launch": [_P] * 15 + [_I] * 4 + [_P],
    # final_rel_grad(r_ptr, r_eid, vals, out, n_rels, d, stream)
    "final_rel_grad_launch": [_P] * 4 + [_I] * 2 + [_P],
    # final_bwd_gru(x, rowptr, src, rel, em, wrel, wstride, wcol, loop, mask,
    #               wih_t, whh_t, bih, bhh, wih, whh, dt, lam, prev, dout,
    #               dprev, n2_out, conv_s, h0g_s, dgi_s, dgh_s, dconv_s,
    #               dlp_s, B, N, d, stream); in the bfloat16 mode x, loop,
    #               the four GRU weights, prev, conv_s and h0g_s bfloat16
    "final_bwd_gru_launch": [_P] * 6 + [_I, _I] + [_P] * 9 + [_F]
                            + [_P] * 10 + [_I] * 3 + [_P],
    # final_bwd_input(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s,
    #                 wrel, wstride, wcol, loop_t, x, ewg, out, B, N, d,
    #                 stream); in the bfloat16 mode loop_t and x bfloat16
    "final_bwd_input_launch": [_P] * 9 + [_I, _I] + [_P] * 4
                              + [_I] * 3 + [_P],
    # final_wgrad(conv_s, dgi_s, h0g_s, dgh_s, x, dlp_s, part, n_split, B, N,
    #             d, stream); in the bfloat16 mode conv_s, h0g_s, x bfloat16
    "final_wgrad_launch": [_P] * 7 + [_I] * 4 + [_P],
    # final_bf16_occupancy(which, d, out): K5's bfloat16 kernel `which` (0
    #             its GRU tile, 1 its input tile, 2 its weight launch) at
    #             width d, or K3's bfloat16 layer launch (3) -> out[5]
    #             (shared memory bytes a block, threads, resident blocks an
    #             SM, registers a thread, local bytes a thread), a host
    #             int[5]
    "final_bf16_occupancy": [_I, _I, _P],
    # final_wgrad_reduce(part, n_split, total, out, stream)
    "final_wgrad_reduce_launch": [_P, _I, ctypes.c_longlong, _P, _P],
    # final_ranks(table, rtab, qsrc, qdst, qrel, qmask, t_ptr, t_ans, h_ptr,
    #             h_ans, part_cnt, tgt_tail, B, N, Q, d, n_split, stream)
    "final_ranks_launch": [_P] * 12 + [_I] * 5 + [_P],
    # final_rank_reduce(part_cnt, tgt_tail, qmask, ranks, bce, B, Q, n_split,
    #                   stream)
    "final_rank_reduce_launch": [_P] * 5 + [_I] * 3 + [_P],
    # bi_layer(x, rowptr, src, rel, em, wrel, wstride, wcol, loop, mask, relu,
    #          wih_f, whh_f, bih_f, bhh_f, wih_b, whh_b, bih_b, bhh_b, dt_f,
    #          dt_b, lam, prev_f, prev_b, active, hl_f, hl_b, imp, sel_x, out,
    #          gin_out, B, N, d, stream); gin_out (the GRU input, for holding
    #          it to K9+K10's recompute) is null on the main path; in the
    #          bfloat16 mode x, loop, the four GRU weight matrices, the
    #          histories and the local tables bfloat16
    "bi_layer_launch": [_P] * 6 + [_I, _I, _P, _P, _I] + [_P] * 10 + [_F]
                       + [_P] * 9 + [_I] * 3 + [_P],
    # bi_bwd_gru(x, rowptr, src, rel, em, wrel, wstride, wcol, loop, mask,
    #            relu, wih_f_t, whh_f_t, bih_f, bhh_f, wih_b_t, whh_b_t,
    #            bih_b, bhh_b, wih_f, whh_f, wih_b, whh_b, dt_f, dt_b, lam,
    #            prev_f, prev_b, active, hl_f, hl_b, imp, dout, dprev_f,
    #            dprev_b, dhl_f, dhl_b, dimp_rows, n2_out, gin_s, h0f_s,
    #            h0b_s, dgi_f, dgh_f, dgi_b, dgh_b, dconv_s, dlp_s, relu_out,
    #            B, N, d, stream); relu_out (the ReLU's pattern, for holding
    #            the kernel to its plain version) is null on the main path;
    #            in the bfloat16 mode x, loop, the eight GRU weight
    #            matrices, the histories, the local tables, gin_s, h0f_s and
    #            h0b_s bfloat16
    "bi_bwd_gru_launch": [_P] * 6 + [_I, _I, _P, _P, _I] + [_P] * 14 + [_F]
                         + [_P] * 23 + [_I] * 3 + [_P],
    # bi_wgrad(gin_s, h0f_s, h0b_s, dgi_f, dgh_f, dgi_b, dgh_b, x, dlp_s,
    #          dimp_rows, part, n_split, B, N, d, stream); in the bfloat16
    #          mode gin_s, h0f_s, h0b_s and x bfloat16
    "bi_wgrad_launch": [_P] * 11 + [_I] * 4 + [_P],
    # bi_bf16_occupancy(which, d, out): K9+K10's bfloat16 kernel `which` (0
    #          its GRU tile, 1 its weight launch) or K6+K7's (2) at width d
    #          -> out[5], as final_bf16_occupancy's
    "bi_bf16_occupancy": [_I, _I, _P],
}

# the launchers whose bfloat16 mode (csrc/*_bf16.cu) is exported as name +
# "_bf16", with the same arguments
BF16_LAUNCHERS = (
    "window_layer_launch", "window_bwd_gru_launch", "window_bwd_input_launch",
    "window_wgrad_launch", "window_occupancy", "final_layer_launch",
    "final_scores_launch", "final_loss_reduce_launch", "final_dq_launch", "final_dq_finish_launch",
    "final_dtable_launch", "final_bwd_gru_launch", "final_bwd_input_launch",
    "final_wgrad_launch", "bi_layer_launch", "bi_bwd_gru_launch",
    "bi_wgrad_launch", "ring_fwd_step_launch", "ring_bwd_step_launch",
    "ring_dw_launch", "spmm_fwd_launch", "spmm_bwd_launch")

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels of temp_tpu_torch cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > lib_mtime for s in SOURCES + HEADERS)


def build() -> str:
    """Compile every kernel source, one nvcc process each and all at once,
    and link them, if the library is missing or older than a source.
    Returns nvcc's -Xptxas -v reports (empty when nothing was built);
    raises with nvcc's stderr when a compile or the link fails."""
    if not SOURCES:
        raise RuntimeError(f"no CUDA sources under {os.path.join(_PKG, 'csrc')}")
    if not _stale():
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{LIB_PATH}.{tag}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
            for src in SOURCES]
    flags = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    procs = [subprocess.Popen(flags + ["-Xptxas", "-v", "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    reports = []
    try:
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"(exit {proc.returncode}):\n{err}")
            reports.append(err)
        link = subprocess.run(flags + ["-shared", "-o", tmp, *objs],
                              capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {link.returncode}):\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.unlink(path)
    return "".join(reports)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(LIB_PATH)
            for name, argtypes in SIGNATURES.items():
                for exported in ((name, f"{name}_bf16")
                                 if name in BF16_LAUNCHERS else (name,)):
                    fn = getattr(cdll, exported)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = cdll
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptxas_summary(text: str) -> str:
    """The register/spill lines of nvcc's -Xptxas -v output, one per kernel."""
    lines = []
    fn = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and ("registers" in line or "spill" in line):
            lines.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return "\n".join(lines)
