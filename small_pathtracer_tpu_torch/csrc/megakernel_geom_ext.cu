// Rows 11 and 12, the geometry and material adjoint (megakernel_geom.cuh),
// on scenes with general quads or GLOS (modified-Phong) objects, every
// estimator code of SPT_EXT_CODES: megakernel_geom_ext<kScan, kEst> and
// megakernel_geom_image_ext<kScan, kEst> under each scan replace the Pallas
// TPU kernel of small_pathtracer_tpu/ops/megakernel_geom.py
// `build_geom_grad_kernel` (:133; `_build_geom_run`, call :1488; row 12 on
// a shard's lanes, call :1686) on those scenes: the plane of each unrolled
// quad (:229-252, :852-856), the Phong lobe's replay (:440-479), the
// Phong direct weight and mis's balance pdfs (:579-614, :981-1010), the
// GLOS continuation and its absorption below the surface (:732-739,
// :1088-1093), mis's continuation pdf (:1117-1127), the differentiable
// lobe whose axis rides d (:905-944), and the quads' material rows
// (`grads_to_scene`, :1544-1553).
//
// The adjoint is megakernel_geom's body (megakernel_geom_body.cuh) with the
// code's scene flags (ext_code: kWithQuads, and kWithGlos for cosine,
// nee_textbook and mis), so each bounce of pass A, of a replay and of the
// sweep is `bounce` of megakernel_lane.cuh with the quads scanned after the
// rects, the quad light's probe (probe_light_quads) and the lobe: pass A
// is the _ext forward (megakernel_ext.cu) bit for bit. The image-only
// launch is that forward's body (`tab_body` with the quads and the
// exponents), so its image and [extend, probe] counts are
// megakernel_<est>_ext's. The pullback adds, in the formulas and order of
// ops/megakernel_geom.py `bounce_vjp`, a quad winner's distance t = ((c −
// o)·n) / (d·n) through its unit normal, the probe's distance to a quad
// light's plane (`nee_vjp_ext`), and at a GLOS vertex the lobe's direction
// and weight through gm = d mirrored about n (`lobe_vjp`), with the Phong
// direct weight and mis's pdfs through gm and the probe direction. The
// tape entry stays GeomTape's 64 bytes: the sweep's bounce recomputes the
// lobe from the taped (o, d) and the draws, the lobe weight enters as the
// bounce's w (0 for a sample absorbed below the surface, whose guarded
// tail divide gives TS = 0), and a GLOS bounce, like a diffuse one, sets
// nee_textbook's suppression and mis's carry (the lobe's pdf) in the
// checkpointed state. The quads are a kernel parameter of their own
// beside Params (a QuadTab) and the exponents a (K,) device array, so
// Params and the other instances are as before.
//
// What bounds them: as megakernel_geom's instances, operations (pass A,
// the sweep's shading and pullback, the replays) and the tape's local
// memory, plus the quad tests of every query and the lobe at every GLOS
// vertex. The instances live in their own translation unit so that the
// library's sources build in parallel (ops/_build.py).

#include "megakernel_geom.cuh"

namespace {

// The image-only launch (bk == 0): the _ext forward's body.
template <int kScan, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_geom_image_ext(const __grid_constant__ Params p,
                              const __grid_constant__ QuadTab qt,
                              const float4* __restrict__ sph, int n_sph,
                              const float4* __restrict__ bvh, int root,
                              const float* __restrict__ alb,
                              const float* __restrict__ emi,
                              const int* __restrict__ refl,
                              const float* __restrict__ gloss,
                              float* __restrict__ out_l,
                              unsigned long long* __restrict__ counts) {
  tab_body<kEst, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,
                        counts, gloss, &qt);
}

// The adjoint launch.
template <int kScan, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_geom_ext(const __grid_constant__ Params p,
                        const __grid_constant__ QuadTab qt,
                        const float4* __restrict__ sph, int n_sph,
                        const float4* __restrict__ bvh, int root,
                        const float* __restrict__ alb,
                        const float* __restrict__ emi,
                        const int* __restrict__ refl,
                        const float* __restrict__ gloss,
                        const float* __restrict__ g_img,
                        float* __restrict__ partials,
                        float* __restrict__ out_l,
                        unsigned long long* __restrict__ counts) {
  const QuadTab* const quads = &qt;
#include "megakernel_geom_body.cuh"
}

using GeomImageExt = void (*)(Params, QuadTab, const float4*, int,
                              const float4*, int, const float*, const float*,
                              const int*, const float*, float*,
                              unsigned long long*);
using GeomAdjointExt = void (*)(Params, QuadTab, const float4*, int,
                                const float4*, int, const float*,
                                const float*, const int*, const float*,
                                const float*, float*, float*,
                                unsigned long long*);

struct GeomExtKernels {
  GeomImageExt image;
  GeomAdjointExt adjoint;
};

GeomExtKernels ext_geom_kernels(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                                       \
  case (e):                                                               \
    return tree ? GeomExtKernels{megakernel_geom_image_ext<kScanTree,     \
                                                           ext_code(e)>,  \
                                 megakernel_geom_ext<kScanTree,           \
                                                     ext_code(e)>}        \
                : GeomExtKernels{megakernel_geom_image_ext<kScanLinear,   \
                                                           ext_code(e)>,  \
                                 megakernel_geom_ext<kScanLinear,         \
                                                     ext_code(e)>};
    SPT_EXT_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return GeomExtKernels{nullptr, nullptr};
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): est any
// code of SPT_EXT_CODES (GLOS objects take 1 cosine, 2 nee_textbook and
// 6 mis only; the wrappers refuse the others first, as the JAX kernel
// does) and mixture_q; the rects as spt_megakernel_geom takes them, then
// quad_f: (n_quads, 19) float32 host rows (geometry/intersect.quad_consts;
// the light may be a quad, light_id < n_rects + n_quads); then the
// arguments of SPT_GEOM_PARAMS from light_f on, with alb, emi (K, 3) and
// refl (K,) over K = n_rects + n_quads + n_spheres objects (rects, quads,
// spheres), gloss: the (K,) float32 Phong exponents in device memory after
// refl, and n_slots = 6·K + 4·n_spheres gradient slots: out holds d/d
// albedo (K, 3), d/d emission (K, 3), d/d sphere rows (n_spheres, 4).
extern "C" int spt_megakernel_geom_ext(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* quad_f, int n_quads, const float* light_f,
    int light_id, const float* cam_f, unsigned seed, int width, int height,
    int spp, int g, int per, unsigned s0, int pix0, int n_pix_loc,
    int rr_start_depth, int max_bounces, const float* sph, int n_spheres,
    const float* bvh, int root, const float* alb, const float* emi,
    const int* refl, const float* gloss, int bk, const float* g_img,
    float* partials, long long n_partials, float* out, float* out_l,
    unsigned long long* counts, void* stream) {
  Params p;
  const bool tree = root >= 0;
  const GeomExtKernels kernels = ext_geom_kernels(est, tree);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces, n_quads) ||
      kernels.image == nullptr || n_spheres < 1 ||
      n_spheres > kMaxGeomSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  return launch_geom_kernels(
      kernels, p, tree, n_rects + n_quads + n_spheres, n_spheres, bk, g_img,
      partials, n_partials, out, out_l, counts, stream,
      fill_quads(p, quad_f, n_quads), reinterpret_cast<const float4*>(sph),
      n_spheres, reinterpret_cast<const float4*>(bvh), root, alb, emi, refl,
      gloss);
}
