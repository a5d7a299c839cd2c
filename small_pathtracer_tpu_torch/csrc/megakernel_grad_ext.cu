// Row 9, the material adjoint (megakernel_vjp.cuh), on scenes with general
// quads or GLOS (modified-Phong) objects, every estimator code of
// SPT_EXT_CODES: megakernel_vjp_ext<kScan, kEst> replaces the Pallas TPU
// kernel of small_pathtracer_tpu/ops/megakernel_grad.py `build_grad_kernel`
// (:129; `_build_vjp`, call :1049) on those scenes: its quad and sphere
// tables (`_runtime_materials` :216-219), the GLOS lobe's replay
// (:388-431), the Phong direct term (:529-543), mis's competing pdf
// (:555-561), the continuation override and the below-horizon kill
// (:671-678) and mis's pdf carry (:841-851). Row 10 runs it on a shard's
// lanes.
//
// It is megakernel_vjp's body (megakernel_vjp_body.cuh) over the sphere
// table's scan
// with the code's scene flags (ext_code: kWithQuads, and kWithGlos for
// cosine, nee_textbook and mis), so each bounce is `bounce_hit` /
// `bounce_scatter` of the forward _ext kernels (megakernel_ext.cu): the
// quads scanned after the rects, the quad light's probe
// (probe_light_quads) and the lobe, bit for bit. The quads are a kernel
// parameter of their own beside Params (a QuadTab, as megakernel_ext takes
// them), the Phong exponents a (K,) device array, so Params and the other
// instances are as before. The sweep needs no field more in its tape entry:
// the lobe weight enters as the bounce's w (0 for a sample absorbed below
// the surface, whose guarded tail divide gives TS = 0), the Phong direct
// weight (times mis's balance weight) as its gate, and the direct term's
// light-emission terms go to the light's global row (a quad's on
// cornell_tilted_light); a GLOS bounce, like a diffuse one, suppresses
// nee_textbook's next pickup of the light and sets mis's carry, the lobe's
// pdf, in the checkpointed state.
//
// What bounds them: as megakernel_grad.cu's instances, operations (one
// trace, the sweep's arithmetic), plus the quad tests of every query and
// the lobe at every GLOS vertex (megakernel_ext.cu), and the tape's local
// memory. The instances live in their own translation unit so that the
// library's sources build in parallel (ops/_build.py).

#include "megakernel_vjp.cuh"

namespace {

template <int kTab, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_vjp_ext(const __grid_constant__ Params p,
                       const __grid_constant__ QuadTab qt,
                       const float4* __restrict__ sph, int n_sph,
                       const float4* __restrict__ bvh, int root,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const int* __restrict__ refl,
                       const float* __restrict__ gloss,
                       const float* __restrict__ g_img,
                       float* __restrict__ partials) {
  const QuadTab* const quads = &qt;
#include "megakernel_vjp_body.cuh"
}

using VjpExtKernel = void (*)(Params, QuadTab, const float4*, int,
                              const float4*, int, const float*, const float*,
                              const int*, const float*, const float*, float*);

VjpExtKernel ext_vjp_kernel(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                                  \
  case (e):                                                          \
    return tree ? megakernel_vjp_ext<kScanTree, ext_code(e)>         \
                : megakernel_vjp_ext<kScanLinear, ext_code(e)>;
    SPT_EXT_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// arguments of SPT_VJP_PARAMS (megakernel_vjp.cuh) with the quads after
// the rects, as spt_megakernel_ext takes them (quad_f: (n_quads, 19)
// float32 host rows; the light may be a quad), no `tab` (the sphere table
// always: sph, bvh and refl as spt_megakernel_tab takes them, 0 spheres
// too), and gloss: the (K,) float32 Phong exponents in device memory, K =
// n_rects + n_quads + n_spheres. est: any code of SPT_EXT_CODES (GLOS
// objects take 1 cosine, 2 nee_textbook and 6 mis only; the wrappers
// refuse the others first, as the JAX kernel does).
extern "C" int spt_megakernel_vjp_ext(
    const float* rect_geom, const int* rect_axis, int n_rects,
    const float* quad_f, int n_quads, const float* light_f, int light_id,
    const float* cam_f, unsigned seed, int width, int height, int spp, int g,
    int per, unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,
    int max_bounces, const float* alb, const float* emi, const float* g_img,
    float* partials, long long n_partials, float* out, int est,
    float mixture_q, const float* sph, int n_spheres, const float* bvh,
    int root, const int* refl, const float* gloss, void* stream) {
  VjpLaunch l;
  const VjpExtKernel kernel = ext_vjp_kernel(est, root >= 0);
  if (kernel == nullptr ||
      !vjp_launch(&l, rect_geom, rect_axis, n_rects, n_quads, light_f,
                  light_id, cam_f, seed, width, height, spp, g, per, s0, pix0,
                  n_pix_loc, rr_start_depth, max_bounces, n_partials,
                  mixture_q, 1, n_spheres, root)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_vjp_kernel(kernel, l, partials, out, stream,
                           fill_quads(l.p, quad_f, n_quads),
                           reinterpret_cast<const float4*>(sph), n_spheres,
                           reinterpret_cast<const float4*>(bvh), root, alb,
                           emi, refl, gloss, g_img);
}
