// Kernel 4's launch plan for the host (conv3d_plan.cuh), read by
// ops/conv3d.py::conv_plan and the CPU tests. Plain C++, built by the host's
// compiler (ops/_build.py).

#include "conv3d_plan.cuh"

extern "C" {

// The plan of a conv with `taps` temporal taps over x [B, T + taps - 1, H,
// W, Cin] (x_bf16: bf16, else fp32; x_tma: x 16-byte aligned) to Cout
// channels on a card of `sms` SMs, into out[27]: route, n, nslices, ck,
// cin_p, cout_p, taps_k, src, stages, nstg, box_f, box_r, box_w, slab_pix,
// tiles_f, tiles_h, tiles_w, walk, ksteps, sw_bytes, w_bytes, stage_bytes,
// stg_bytes, epilogue_bytes, smem, blocks, and the kernel's shared-memory
// limit. 0 where no route takes the shape, else 1.
int wf_conv3d_plan(int taps, int B, int T, int H, int W, int Cin, int Cout,
                   int x_bf16, int x_tma, int sms, long long* out) {
  conv4::Plan p;
  if (!conv4::make_plan(taps, B, T, H, W, Cin, Cout, x_bf16, x_tma, sms, &p))
    return 0;
  const long long fields[27] = {
      p.route,    p.n,          p.nslices,     p.ck,        p.cin_p,
      p.cout_p,   p.taps_k,     p.src,         p.stages,    p.nstg,
      p.box_f,    p.box_r,      p.box_w,       p.slab_pix,  p.tiles_f,
      p.tiles_h,  p.tiles_w,    p.walk,        p.ksteps,    p.sw_bytes,
      p.w_bytes,  p.stage_bytes, p.stg_bytes,  p.epilogue_bytes,
      p.smem,     p.blocks,     conv4::kSmemLimit};
  for (int i = 0; i < 27; ++i) out[i] = fields[i];
  return 1;
}

}  // extern "C"
