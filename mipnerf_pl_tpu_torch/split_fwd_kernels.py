"""Where the lean forward spends its time, by switching parts off.

    cd <root of a checkout> && python3 <this file> [--f32] [--sm90 | --tf32 | --chain | --tune | --wgrad] [--only=BITS]

copies the checkout's csrc/ to a temporary directory, adds a compile-time
mask FWD_OFF to the copy of lean_engines.cuh (nothing in the checkout
changes), builds lean_render.cu and lean_train.cu once a mask with nvcc
(sm_90a, all at once), and times, from torch.profiler kernel durations,
the forward kernel of bf16 lean_save_fwd and lean_fwd (encode rows and
the moments) at the lego training level (chip_smoke.py's level_inputs) and of
bf16 lean_mlp at one 8192-ray render chunk (chip_smoke.py's chunk_inputs),
seeded weights.  The mask's bits switch off, in the mma.sync tile
(mlp_tile): 1 the weight loads (the slab is filled with zeros), 2 the
products, 4 the epilogue and the in-place store of each layer, 8 the copies
of the tiles to the saved stream (copy_tile_out), 16 the heads' dots, 32
the IPE decode of the moments (decode_moments in lean_engines.cuh, which
the wgmma forwards call too: their bit 32 is the same switch; the decode
then stores zeros).  The results are a split, not a sum: with
a part off the compiler and the scheduler may rearrange the rest.  It
prints one JSON line a mask and one with all of them and the unmasked
profile.  In a tree whose bf16 lean forwards take lean_fwd_sm90_kernel,
run it from a parent checkout: these masks reach only the mma.sync tile.

With --sm90 the masks go into lean_fwd_sm90.cuh instead and it times
lean_fwd_sm90_kernel: 1 the weight slabs' TMA loads (the producer
completes each slab's barrier without them), 2 the wgmma products, 4 the
epilogue (bias, vproj, ReLU and the stmatrix stores), 8 the TMA stores of
the saved stream, 16 the heads' dots, 32 the IPE decode; it also times
its classic form in bf16 mlp_fwd at the lego level (the view repeated
over the samples), with a view layer and, with the lego trunk's seeded
weights for net_depth_condition 0, its NV form (`mlp_fwd classic`,
`mlp_fwd classic no_view`).

--only=BITS (comma-separated masks, e.g. --only=0,2,16) builds and times
only those of the masks.  The build prints what ptxas says of the timed
kernels (registers, stack, spills) as the first mask builds them.  Bit 32
also finds the inline decode of a checkout from before decode_moments, so
`cd <parent checkout> && python3 <this tree's file> ...` splits a parent
in turns with this tree.

With --f32 the forwards run in f32: the masks then reach the mma.sync
tile's 3xTF32 engine (Tf32Gemm), where bit 2 drops the products with the
on-the-fly split of both operands, and bit 64 keeps the products but drops
the split (hi = the raw f32 word, lo = 0: the same count of mma.sync).
With --tf32 (f32 too) the masks go into lean_fwd_tf32.cuh and time
lean_fwd_tf32_kernel: 1 the weight slabs' TMA loads, 2 the wgmma products
with the A operand's loads and split, 4 the epilogue (bias, vproj, ReLU, the
in-place store), 8 the copies of the tiles to the saved stream, 16 the
heads' dots, 32 the IPE decode, 64 the A operand's split alone.

With --chain it times the f32 cotangent chain lean_chain_tf32_kernel of
lean_param_grads at the lego level, on the stream of f32 lean_save_fwd:
the bits 2 and 64 as with --tf32 (the products' helper is shared), and in
lean_chain_tf32.cuh 1 the weight slabs' TMA loads, 4 the epilogue of each
product step (a layer's: the density term and the store into the tile; the
classic form's input cotangents: their stores), 8 the copy pass (the mask,
and the copies to G and g1f), 16 the bias column sums, 32 the mask alone.

`masked_sources` raises if a switch's text is not found exactly once in
today's headers; tests/test_torch_split_tool.py applies every mode's
switches on the CPU, so a header change that moves a pattern shows there.

With --wgrad it times the f32 weight-gradient kernel wgrad_tf32_kernel of
lean_param_grads at the lego level, on the stream of f32 lean_save_fwd, in
the forms of WGRAD_VARIANTS: its compile-time constants in
lean_wgrad_tf32.cuh (which rows go to registers, the stages of products
in flight, ring stages, stages between the accumulators' restarts) and two parts off (bit 1 the lo pass of the
shared operand, bit 2 the register operand's split: hi = the word, lo =
0).  Only lean_train.cu is built.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
from mipnerf_pl_tpu_torch import config  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import _build  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import mlp as km  # noqa: E402
from mipnerf_pl_tpu_torch.system import MipNeRFSystem  # noqa: E402
import chip_smoke as cs  # noqa: E402

# --tune: (ring stages, slabs the first warpgroup starts ahead) of
# lean_fwd_sm90_kernel, all parts on.
TUNES = [(7, 1), (7, 2), (7, 3), (7, 5), (6, 1), (6, 3)]


def configure(argv):
    """Set the mode globals (CHAIN, WGRAD, TUNE, SM90, F32, TF32, LIBS,
    VARIANTS, ONLY) from the command-line arguments `argv`."""
    global CHAIN, WGRAD, TUNE, SM90, F32, TF32, LIBS, VARIANTS, ONLY
    CHAIN = '--chain' in argv
    WGRAD = '--wgrad' in argv
    TUNE = '--tune' in argv
    SM90 = '--sm90' in argv or TUNE
    LIBS = ('lean_train',) if WGRAD else ('lean_render', 'lean_train')
    F32 = CHAIN or WGRAD or any(a in argv for a in ('--f32', '--tf32'))
    TF32 = '--tf32' in argv or CHAIN
    VARIANTS = {0: 'all on', 1: 'weight loads off', 2: 'products off',
                4: 'epilogue + store off', 8: 'copy_tile_out off',
                16: 'heads off', 32: 'IPE decode off',
                6: 'products + epilogue off'}
    if F32:
        VARIANTS[64] = 'operand split off'
    if CHAIN:
        VARIANTS = {0: 'all on', 1: 'weight loads off', 2: 'products off',
                    4: 'epilogue off', 8: 'copy pass off',
                    16: 'bias sums off', 32: 'mask reads off',
                    64: 'operand split off', 24: 'copy pass + bias sums off'}
    ONLY = next((a.split('=', 1)[1] for a in argv
                 if a.startswith('--only=')), None)
    if ONLY is not None:
        VARIANTS = {int(v): VARIANTS[int(v)] for v in ONLY.split(',')}


# --wgrad: label -> (G rows in registers, stages of products in flight,
# ring stages, stages between restarts, parts off) of wgrad_tf32_kernel.
WGRAD_VARIANTS = {
    'as built': (1, 1, 5, 4, 0),
    'activation rows in registers': (0, 1, 5, 4, 0),
    'two stages in flight': (1, 2, 5, 4, 0),
    '4 stages': (1, 1, 4, 4, 0),
    'restart every 256 points': (1, 1, 5, 8, 0),
    'restart every 512 points': (1, 1, 5, 16, 0),
    'no restarts': (1, 1, 5, 1 << 20, 0),
    'lo pass off': (1, 1, 5, 4, 1),
    'register split off': (1, 1, 5, 4, 2),
}
# (text of lean_engines.cuh, the same text behind the mask's bit).
SWITCHES = [
    ('namespace {\n\nconstexpr int TM = 64;',
     '#ifndef FWD_OFF\n#define FWD_OFF 0\n#endif\nnamespace {\n\nconstexpr int TM = 64;'),
    ('      if (kk < KT && k0 + kk < K)\n        val =',
     '      if (!(FWD_OFF & 1) && kk < KT && k0 + kk < K)\n        val ='),
    ('      for (int kk = 0; kk < ktp; kk += 16) {',
     '      for (int kk = 0; kk < ((FWD_OFF & 2) ? 0 : ktp); kk += 16) {'),
    # Tf32Gemm (f32): the products with both operands' split; the split.
    ('      uint32_t ahi[2][4], alo[2][4];',
     '      if (FWD_OFF & 2) {\n        __syncthreads();\n        continue;\n      }\n'
     '      uint32_t ahi[2][4], alo[2][4];'),
    ('__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {\n',
     '__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {\n'
     '  if (FWD_OFF & 64) {\n    hi = __float_as_uint(x);\n    lo = 0u;\n    return;\n  }\n'),
    ('  gemm.transform(n_out, [&](int row, int col, float x) {\n'
     '    return epilogue(x, row, col, bias, vproj, d, m0, relu);',
     '  if (FWD_OFF & 4) { __syncthreads(); return; }\n'
     '  gemm.transform(n_out, [&](int row, int col, float x) {\n'
     '    return epilogue(x, row, col, bias, vproj, d, m0, relu);'),
    ('  constexpr int VEC = 16 / sizeof(T), PER_ROW = TM / VEC;\n'
     '  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {\n'
     '    const int r = v / PER_ROW, c = (v - r * PER_ROW) * VEC;\n'
     '    *reinterpret_cast<uint4*>(dst',
     '  constexpr int VEC = 16 / sizeof(T), PER_ROW = TM / VEC;\n'
     '  if (FWD_OFF & 8) return;\n'
     '  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {\n'
     '    const int r = v / PER_ROW, c = (v - r * PER_ROW) * VEC;\n'
     '    *reinterpret_cast<uint4*>(dst'),
    ('                          int n_out, int col, int row) {\n  float s = 0.f;',
     '                          int n_out, int col, int row) {\n'
     '  if (FWD_OFF & 16) return bias[col];\n  float s = 0.f;'),
]
# Bit 32 in every form: decode_moments (lean_engines.cuh), the one IPE
# decode of the moments that the mma.sync tile and both wgmma forwards call,
# stores zeros instead of its values.
SWITCHES_DECODE = [
    ('    if (m < M) {\n      const float mean = x[(size_t)dim * ldx + m];',
     '    if (!(FWD_OFF & 32) && m < M) {\n      const float mean = x[(size_t)dim * ldx + m];'),
]
# Bit 32 in a checkout from before decode_moments (a parent timed in turns),
# where each forward decoded the moments inline with libm sinf: its file ->
# the switch there.
_INLINE_DECODE = (
    '        if (m < pl.M) {\n          const int k = f / 3, dim = f - 3 * k;',
    '        if (!(FWD_OFF & 32) && m < pl.M) {\n'
    '          const int k = f / 3, dim = f - 3 * k;')
SWITCHES_DECODE_INLINE = {
    'lean_engines.cuh': [(
        '      if constexpr (MOMENTS)\n        v = ipe_feature(x, ldx, m, f, L, min_deg);',
        '      if constexpr (MOMENTS)\n'
        '        v = (FWD_OFF & 32) ? 0.5f : ipe_feature(x, ldx, m, f, L, min_deg);')],
    'lean_fwd_sm90.cuh': [_INLINE_DECODE],
    'lean_fwd_tf32.cuh': [_INLINE_DECODE],
}


# The same bits in lean_fwd_sm90.cuh (--sm90).
SWITCHES_SM90 = [
    ('namespace {\n\nconstexpr int FW_TM = 128;',
     '#ifndef FWD_OFF\n#define FWD_OFF 0\n#endif\nnamespace {\n\n'
     'constexpr int FW_TM = 128;'),
    ('        mbar_expect_tx(full + s, nb * FW_WBOX);',
     '        if (FWD_OFF & 1) {\n          mbar_arrive(full + s);\n          continue;\n'
     '        }\n        mbar_expect_tx(full + s, nb * FW_WBOX);'),
    ('            if constexpr (NBC == 4) {\n              wgmma_tt_m64n256(',
     '            if constexpr ((FWD_OFF & 2) != 0) {\n'
     '            } else if constexpr (NBC == 4) {\n              wgmma_tt_m64n256('),
    ('        for (int nb = 0; nb < NBC; ++nb) {\n#pragma unroll\n'
     '          for (int j = 0; j < 8; ++j) {',
     '        for (int nb = 0; nb < ((FWD_OFF & 4) ? 0 : NBC); ++nb) {\n#pragma unroll\n'
     '          for (int j = 0; j < 8; ++j) {'),
    ('        for (int nb = 0; nb < NBC; ++nb) {\n#pragma unroll\n'
     '          for (int jp = 0; jp < 4; ++jp) {',
     '        for (int nb = 0; nb < ((FWD_OFF & 4) ? 0 : NBC); ++nb) {\n#pragma unroll\n'
     '          for (int jp = 0; jp < 4; ++jp) {'),
    ('            tma_store_2d(&pl.s,', '            if (!(FWD_OFF & 8)) tma_store_2d(&pl.s,'),
    ('        tma_store_2d(&pl.sx,', '        if (!(FWD_OFF & 8)) tma_store_2d(&pl.sx,'),
    ('      if (den || li == pl.n_layers - 1) {',
     '      if (!(FWD_OFF & 16) && (den || li == pl.n_layers - 1)) {'),
]
# The chain's own bits in lean_chain_tf32.cuh (--chain).
SWITCHES_CHAIN = [
    ('            mbar_expect_tx(full + s, 2 * st.N * FT_SW);',
     '            if (FWD_OFF & 1) {\n              mbar_arrive(full + s);\n              continue;\n'
     '            }\n            mbar_expect_tx(full + s, 2 * st.N * FT_SW);'),
    # The epilogue of a layer's step (the density term, the store into the
    # tile) and of an input-cotangent step of the classic form.
    ('          for (int j = 0; j < NC / 8; ++j) {\n#pragma unroll\n'
     '            for (int e = 0; e < 4; ++e) {\n              const int col =',
     '          for (int j = 0; j < ((FWD_OFF & 4) ? 0 : NC / 8); ++j) {\n'
     '#pragma unroll\n            for (int e = 0; e < 4; ++e) {\n'
     '              const int col ='),
    ('          for (int j = 0; j < NC / 8; ++j) {\n#pragma unroll\n'
     '            for (int e = 0; e < 4; ++e) {\n              const int i =',
     '          for (int j = 0; j < ((FWD_OFF & 4) ? 0 : NC / 8); ++j) {\n'
     '#pragma unroll\n            for (int e = 0; e < 4; ++e) {\n'
     '              const int i ='),
    ('        if (st.act) {\n          x.x =', '        if (!(FWD_OFF & 32) && st.act) {\n          x.x ='),
    ('        if (v >= st.N * 16) break;', '        if ((FWD_OFF & 8) || v >= st.N * 16) break;'),
    ('      if (tid < st.N) {', '      if (!(FWD_OFF & 16) && tid < st.N) {'),
]
# The same bits in lean_fwd_tf32.cuh (--tf32).
SWITCHES_TF32 = [
    ('namespace {\n\nconstexpr int FT_TM = 64;',
     '#ifndef FWD_OFF\n#define FWD_OFF 0\n#endif\nnamespace {\n\n'
     'constexpr int FT_TM = 64;'),
    ('        mbar_expect_tx(full + s, 2 * n * FT_SW);',
     '        if (FWD_OFF & 1) {\n          mbar_arrive(full + s);\n          continue;\n'
     '        }\n        mbar_expect_tx(full + s, 2 * n * FT_SW);'),
    ('    uint32_t ah[2][4], al[2][4];\n    tf32_load_a(',
     '    uint32_t ah[2][4] = {}, al[2][4] = {};\n    if (!(FWD_OFF & 2)) tf32_load_a('),
    ('      tf32_mma<NC>(acc, al[kk], dh, ks > 0 || kk > 0);',
     '      if (FWD_OFF & 2) continue;\n      tf32_mma<NC>(acc, al[kk], dh, ks > 0 || kk > 0);'),
    ('        for (int j = 0; j < NC / 8; ++j) {\n          const int col = col0 + 8 * j + 2 * t;',
     '        for (int j = 0; j < ((FWD_OFF & 4) ? 0 : NC / 8); ++j) {\n'
     '          const int col = col0 + 8 * j + 2 * t;'),
    ('      if (pl.S) save(hs, ly.N, ly.s_row);',
     '      if (pl.S && !(FWD_OFF & 8)) save(hs, ly.N, ly.s_row);'),
    ('    if (pl.S) save(xs, pl.Fx, 0);', '    if (pl.S && !(FWD_OFF & 8)) save(xs, pl.Fx, 0);'),
    ('      if (den || li == pl.n_layers - 1) {',
     '      if (!(FWD_OFF & 16) && (den || li == pl.n_layers - 1)) {'),
    ('    split_tf32(s[0], ah[kk][0], al[kk][0]);',
     '    if (FWD_OFF & 64) {\n#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n'
     '        const float v = s[(i & 1) * 8 + (i >> 1) * 4 * FT_LD];\n'
     '        ah[kk][i] = __float_as_uint(v);\n        al[kk][i] = 0u;\n      }\n'
     '      continue;\n    }\n    split_tf32(s[0], ah[kk][0], al[kk][0]);'),
]
# --wgrad makes the constants of lean_wgrad_tf32.cuh compile-time options
# and adds the parts' switches.
SWITCHES_WGRAD = [
    ('constexpr int WT_STAGES = 5;',
     '#ifndef WT_OFF\n#define WT_OFF 0\n#endif\n'
     'constexpr int WT_STAGES = WT_STAGES_N;'),
    ('constexpr int WT_RESTART = 4;', 'constexpr int WT_RESTART = WT_RESTART_N;'),
    ('constexpr bool WT_GA = true;', 'constexpr bool WT_GA = WT_GA_N;'),
    ('constexpr int WT_INFLIGHT = 1;', 'constexpr int WT_INFLIGHT = WT_INFLIGHT_N;'),
    ('  auto split_lo = [&](int k) {\n',
     '  auto split_lo = [&](int k) {\n    if (WT_OFF & 1) return;\n'),
    ('      split_tf32(row0[ca], ah[kk][0], al[kk][0]);',
     '      if (WT_OFF & 2) {\n'
     '        const float v[4] = {row0[ca], row1[ca], row0[cb], row1[cb]};\n'
     '        for (int i = 0; i < 4; ++i) {\n'
     '          ah[kk][i] = __float_as_uint(v[i]);\n          al[kk][i] = 0u;\n'
     '        }\n        continue;\n      }\n'
     '      split_tf32(row0[ca], ah[kk][0], al[kk][0]);'),
]
# --tune makes the two constants of the copy compile-time options.
SWITCHES_TUNE = [
    ('constexpr int FW_STAGES = 6;',
     '#ifndef FW_STAGES_N\n#define FW_STAGES_N 6\n#endif\n'
     'constexpr int FW_STAGES = FW_STAGES_N;'),
    ('constexpr int FW_LAG = 3;',
     '#ifndef FW_LAG_N\n#define FW_LAG_N 3\n#endif\nconstexpr int FW_LAG = FW_LAG_N;'),
]


configure([])


def variants():
    """{label: the nvcc -D flags of its build}."""
    if TUNE:
        return {f'{n} stages, lag {lag}': [f'-DFW_STAGES_N={n}',
                                           f'-DFW_LAG_N={lag}']
                for n, lag in TUNES}
    if WGRAD:
        return {label: [f'-DWT_GA_N={ga}', f'-DWT_INFLIGHT_N={inflight}',
                        f'-DWT_STAGES_N={st}', f'-DWT_RESTART_N={rs}',
                        f'-DWT_OFF={off}']
                for label, (ga, inflight, st, rs, off)
                in WGRAD_VARIANTS.items()}
    return {label: [f'-DFWD_OFF={v}'] for v, label in VARIANTS.items()}


def masked_sources(tmp):
    """csrc/ copied to tmp with the switches in lean_engines.cuh (--sm90:
    lean_fwd_sm90.cuh; --tf32: lean_fwd_tf32.cuh; bit 32 in lean_engines.cuh
    in every form)."""
    dst = os.path.join(tmp, 'csrc')
    shutil.copytree(_build.SRC_DIR, dst)
    name = ('lean_fwd_tf32.cuh' if TF32 else 'lean_fwd_sm90.cuh' if SM90
            else 'lean_engines.cuh')
    edits = {name: (SWITCHES_TUNE if TUNE else SWITCHES_TF32 if TF32
                    else SWITCHES_SM90 if SM90 else SWITCHES)}
    if WGRAD:
        edits = {'lean_wgrad_tf32.cuh': SWITCHES_WGRAD}
    if CHAIN:
        edits['lean_chain_tf32.cuh'] = SWITCHES_CHAIN
    elif not (WGRAD or TUNE):
        engines = open(os.path.join(dst, 'lean_engines.cuh')).read()
        if 'decode_moments' in engines:
            edits['lean_engines.cuh'] = edits.get('lean_engines.cuh', []) + \
                SWITCHES_DECODE
        else:
            edits[name] = edits[name] + SWITCHES_DECODE_INLINE[name]
    for name, switches in edits.items():
        path = os.path.join(dst, name)
        text = open(path).read()
        for old, new in switches:
            if text.count(old) != 1:
                raise RuntimeError(f'{name} has no single {old!r}')
            text = text.replace(old, new)
        open(path, 'w').write(text)
    return dst


def build(tmp):
    src = masked_sources(tmp)
    procs = {}
    t0 = time.perf_counter()
    for v, (label, flags) in enumerate(variants().items()):
        for name in LIBS:
            so = os.path.join(tmp, f'lib{name}-{v}.so')
            cmd = [_build.nvcc_path(), *_build.FLAGS, *flags, '-o',
                   so, os.path.join(src, f'{name}.cu')]
            procs[(v, name)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(out)
        libs[key] = so
        if key[0] == 0:     # what ptxas says of the timed kernels, as built
            for kname, spill, regs in cs.kernel_resources(out):
                if any(n in kname for n in timed_kernels()):
                    print(f'ptxas {key[1]}: {short(kname)}: {regs}; {spill}',
                          flush=True)
    print(f'build {time.perf_counter() - t0:.1f} s', flush=True)
    return libs


def timed_kernels():
    """Names of the kernels whose device time a row holds."""
    return (('wgrad_tf32_kernel',) if WGRAD
            else ('lean_chain_tf32_kernel',) if CHAIN
            else ('lean_fwd_tf32_kernel',) if TF32
            else ('lean_fwd_sm90_kernel',) if SM90
            else ('lean_fwd_kernel', 'lean_mlp_kernel'))


def short(name):
    name = name.replace('(anonymous namespace)::', '')
    return re.sub(r'^void ', '', name).split('(')[0][-60:]


def main():
    configure(sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        run(build(tmp))


def run(libs):
    dev = torch.device('cuda')
    hp = config.default()
    depth, dcond = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition']
    params = MipNeRFSystem(hp, device=dev).init_params(seed=0)
    flat = cs.flat_params(params, hp)
    args = (hp['nerf.num_samples'], depth, dcond, hp['nerf.mlp.skip_index'])
    enc = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])
    x, view, g_rgb, g_dens, moments, _, _ = cs.level_inputs(hp, dev)
    cm, cview, _, _ = cs.chunk_inputs(hp, dev)
    iv = 2 * (depth + 2)
    W = flat[0].shape[1]
    vp = km.view_proj_plain(cview, flat[iv], flat[iv + 1], W, torch.float32)
    dt = torch.float32 if F32 else torch.bfloat16
    calls = {
        'lean_save_fwd rows': lambda: km.lean_save_fwd(x, view, flat, *args,
                                                       dt, cs.ACT),
        'lean_save_fwd moments': lambda: km.lean_save_fwd(
            moments, view, flat, *args, dt, cs.ACT, encode=enc),
        'lean_fwd rows': lambda: km.lean_fwd(x, view, flat, *args, dt,
                                             cs.ACT),
        'lean_fwd moments': lambda: km.lean_fwd(
            moments, view, flat, *args, dt, cs.ACT, encode=enc),
        'lean_mlp chunk': lambda: km.lean_mlp(cm, vp, flat, *args, dt,
                                              cs.ACT, enc),
    }
    if SM90:
        # The classic form and its NV form (no view layer) of mlp_fwd.
        vpts = view.repeat_interleave(hp['nerf.num_samples'], dim=0)
        for key, extra in (('classic', {}), ('classic no_view', cs._NO_VIEW)):
            hc = dict(hp, **extra)
            fc = cs.flat_params(
                MipNeRFSystem(hc, device=dev).init_params(seed=0), hc)
            ca = (hc['nerf.mlp.net_depth'], hc['nerf.mlp.net_depth_condition'],
                  hc['nerf.mlp.skip_index'])
            calls[f'mlp_fwd {key}'] = (
                lambda fc=fc, ca=ca: km.mlp_fwd(x, vpts, fc, *ca, dt))
    saved = []
    if CHAIN or WGRAD:
        calls = {'lean_param_grads': lambda: km.lean_param_grads(
            view, g_rgb, g_dens, saved[-1], flat, *args, dt, cs.ACT)}
    out = {'smi': cs.smi_line()}
    for v, label in enumerate(variants()):
        _build._LOADED.clear()
        for name in LIBS:
            _build._LOADED[name] = ctypes.CDLL(libs[(v, name)])
        if CHAIN or WGRAD:
            saved[:] = [km.lean_save_fwd(x, view, flat, *args, dt, cs.ACT)[2]]
        row = {}
        for cname, fn in calls.items():
            split = cs.kernel_device_ms(fn, iters=5)
            names = timed_kernels()
            row[cname] = round(sum(t for k, t in split.items()
                                   if any(n in k for n in names)), 4)
            if v == 0:
                out[f'profile {cname}'] = {short(k): round(t, 4)
                                           for k, t in split.items()}
        out[label] = row
        print(json.dumps({label: row}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
