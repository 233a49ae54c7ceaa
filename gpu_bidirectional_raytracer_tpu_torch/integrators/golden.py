"""Scalar golden-model integrator (the oracle), in numpy.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/golden.py``: an
independent, structurally scalar implementation of the eye-path and
light-subpath integrators that the batched tracers are tested against,
in float64 numpy, one ray or lane at a time, with the loops, branch order
and early returns of the reference's ``RadiancePathTracing`` /
``RadianceDirectLighting`` / ``SampleLights`` (``geomfunc.h:152-789``) and
its VPL gather (``device.cu:457-542``).

It consumes the counter-addressed tape of the tracers (`make_tape`,
`make_light_tape`: the same `rng.site_uniforms` sites, drawn on the CPU),
so a radiance mismatch is an algorithmic divergence, not a different
random draw. Deliberately slow; for tests on small images.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    EPSILON,
    SPEC,
    IntegratorConfig,
)

_NC, _NT = 1.0, 1.5


def _site(key: rng.Key, sample: int, depth: int, purpose: int, k: int,
          n: int) -> np.ndarray:
    """``[k, n]`` uniforms of one draw site (`rng.site_uniforms` on the
    CPU) as numpy float32."""
    return rng.site_uniforms(key, sample, depth, purpose, k, n,
                             device="cpu").numpy()


def make_tape(key, sample, n_pixels: int, n_lights: int,
              cfg: IntegratorConfig) -> dict:
    """Materialize the random tape for one progressive sample as numpy.

    Calls the exact same `rng.site_uniforms` sites the vectorized tracer
    calls, so the tapes are bitwise identical. ``('light', d)`` is indexed
    by light SLOT (position among emissive spheres in scan order).
    """
    n_l = max(n_lights, 1)
    tape = {"cam": _site(key, sample, 0, rng.CAM_JITTER, 2, n_pixels)}
    for d in range(cfg.max_depth):
        tape[("light", d)] = _site(key, sample, d, rng.LIGHT_UV, 2 * n_l,
                                   n_pixels).reshape(n_l, 2, n_pixels)
        tape[("diff", d)] = _site(key, sample, d, rng.DIFF_UV, 2, n_pixels)
        tape[("rr", d)] = _site(key, sample, d, rng.REFR_RR, 1, n_pixels)[0]
    return tape


def _norm(v):
    return v / np.sqrt(v @ v)


def _sphere_intersect(rad, p, o, d):
    """geomfunc.h:31-58 — smaller positive root > EPSILON, else larger, else 0."""
    op = p - o
    b = op @ d
    det = b * b - op @ op + rad * rad
    if det < 0.0:
        return 0.0
    det = np.sqrt(det)
    t = b - det
    if t > EPSILON:
        return t
    t = b + det
    return t if t > EPSILON else 0.0


def _intersect(scene, o, d):
    """geomfunc.h:111-132 — scan i = S-1 .. 0, strict '<'."""
    t = 1e20
    hit_id = 0
    for i in range(scene["rad"].shape[0] - 1, -1, -1):
        dist = _sphere_intersect(scene["rad"][i], scene["p"][i], o, d)
        if dist != 0.0 and dist < t:
            t = dist
            hit_id = i
    return (t < 1e20), t, hit_id


def _intersect_p(scene, o, d, maxt, vacuum=False):
    """geomfunc.h:134-150 / device.cu:141-154 (vacuum skips emitters)."""
    for i in range(scene["rad"].shape[0] - 1, -1, -1):
        if vacuum and np.any(scene["e"][i] != 0.0):
            continue
        dist = _sphere_intersect(scene["rad"][i], scene["p"][i], o, d)
        if dist != 0.0 and dist < maxt:
            return True
    return False


def _uniform_sphere(u1, u2):
    zz = 1.0 - 2.0 * u1
    r = np.sqrt(max(0.0, 1.0 - zz * zz))
    phi = 2.0 * np.pi * u2
    return np.array([r * np.cos(phi), r * np.sin(phi), zz])


def _sample_lights(scene, cfg, hp, nl, light_u, pix, vpls, vlp_index):
    """geomfunc.h:152-207 + device.cu:457-542 (VPL part when cfg.use_vpl)."""
    result = np.zeros(3)
    slot = -1  # light tape column: emissive-sphere ordinal in scan order
    for i in range(scene["rad"].shape[0]):
        if not np.any(scene["e"][i] != 0.0):
            continue
        slot += 1
        usp = _uniform_sphere(light_u[slot, 0, pix], light_u[slot, 1, pix])
        sphere_point = scene["p"][i] + scene["rad"][i] * usp
        sdir = sphere_point - hp
        length = np.sqrt(sdir @ sdir)
        sdir = sdir / length
        wo = sdir @ usp
        if wo > 0.0:
            continue
        wo = -wo
        wi = sdir @ nl
        if wi > 0.0 and not _intersect_p(scene, hp, sdir, length - EPSILON):
            s = (4.0 * np.pi * scene["rad"][i] ** 2) * wi * wo / (length * length)
            result = result + scene["e"][i] * cfg.light_gain * s

    if not cfg.use_vpl or vpls is None:
        return result

    vlp_sum = np.zeros(3)
    k_total = cfg.vpl_depth * cfg.max_vlp
    for j in range(vlp_index, vlp_index + cfg.max_vlp):
        jj = j % cfg.light_points
        for k in range(cfg.vpl_depth):
            if not vpls["valid"][k, jj]:
                continue
            sdir = vpls["hp"][k, jj] - hp
            length = np.sqrt(sdir @ sdir)
            sdir = sdir / length
            wo = sdir @ vpls["nl"][k, jj]
            if wo > 0.0:
                continue
            wo = -wo
            wi = sdir @ nl
            if wi > 0.0 and not _intersect_p(scene, hp, sdir, length - EPSILON,
                                             vacuum=True):
                vlp_sum = vlp_sum + vpls["rad"][k, jj] * (wi * wo)
    total = result + vlp_sum / k_total
    return total * 0.5 if cfg.combine_half else total


def radiance_path_tracing(scene, cfg: IntegratorConfig, o, d, tape, pix,
                          vpls=None, vlp_index=0, direct_only=False):
    """geomfunc.h:473-644 (or :646-789 with direct_only) for one eye ray."""
    o = np.array(o, dtype=np.float64)
    d = np.array(d, dtype=np.float64)
    rad = np.zeros(3)
    throughput = np.ones(3)
    specular = True

    for depth in range(cfg.max_depth):
        hit, t, hid = _intersect(scene, o, d)
        if not hit:
            return rad
        hp = o + t * d
        normal = _norm(hp - scene["p"][hid])
        dp = normal @ d
        inv_sign_dp = -1.0 if dp > 0.0 else 1.0
        nl = inv_sign_dp * normal

        e = scene["e"][hid]
        if np.any(e != 0.0):
            if specular:
                rad = rad + throughput * (cfg.emission_scale * abs(dp)) * e
            return rad

        refl = int(scene["refl"][hid])
        albedo = scene["c"][hid]

        if refl == DIFF:
            specular = False
            throughput = throughput * albedo
            ld = _sample_lights(scene, cfg, hp, nl, tape[("light", depth)],
                                pix, vpls, vlp_index)
            rad = rad + throughput * ld
            if direct_only:
                return rad
            r1 = 2.0 * np.pi * tape[("diff", depth)][0, pix]
            r2 = tape[("diff", depth)][1, pix]
            r2s = np.sqrt(r2)
            w = nl
            a = (np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.1
                 else np.array([1.0, 0.0, 0.0]))
            u = _norm(np.cross(a, w))
            v = np.cross(w, u)
            d = u * (np.cos(r1) * r2s) + v * (np.sin(r1) * r2s) + w * np.sqrt(1.0 - r2)
            o = hp
        elif refl == SPEC:
            specular = True
            d = d - 2.0 * (normal @ d) * normal
            throughput = throughput * albedo
            o = hp
        else:
            specular = True
            refl_dir = d - 2.0 * (normal @ d) * normal
            into = (normal @ nl) > 0.0
            nnt = _NC / _NT if into else _NT / _NC
            ddn = d @ nl
            cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
            if cos2t < 0.0:  # total internal reflection
                throughput = throughput * albedo
                d = refl_dir
                o = hp
            else:
                kk = (1.0 if into else -1.0) * (ddn * nnt + np.sqrt(cos2t))
                trans_dir = _norm(nnt * d - kk * normal)
                r0 = ((_NT - _NC) / (_NT + _NC)) ** 2
                c1 = 1.0 - (-ddn if into else trans_dir @ normal)
                re = r0 + (1.0 - r0) * c1 ** 5
                p = 0.25 + 0.5 * re
                if tape[("rr", depth)][pix] < p:
                    throughput = throughput * (re / p) * albedo
                    d = refl_dir
                else:
                    throughput = throughput * ((1.0 - re) / (1.0 - p)) * albedo
                    d = trans_dir
                o = hp
    return rad


def make_light_tape(key, sample, cfg: IntegratorConfig, n_lanes: int) -> dict:
    """Tape for the light pass, same sites as `light_tracer`."""
    tape = {"emit": _site(key, sample, 0, rng.LIGHT_RAY_UV, 4, n_lanes)}
    for d in range(cfg.vpl_depth):
        tape[("scatter", d)] = _site(key, sample, d, rng.LIGHT_SCATTER, 3,
                                     n_lanes)
    return tape


def radiance_light_tracing(scene, cfg: IntegratorConfig,
                           light_idx: tuple[int, ...], tape, lane: int):
    """Scalar mirror of the light-subpath walk (`light_tracer` intent;
    reference ``RadianceLightTracingKernel``, device.cu:222-455).

    Returns a list of ``cfg.vpl_depth`` slots, each None or a dict
    ``{hp, rad, nl}``.
    """
    L = len(light_idx)
    lig = light_idx[lane % L]
    lrad = scene["rad"][lig]
    lp = scene["p"][lig]
    le = scene["e"][lig]

    u = tape["emit"][:, lane]
    usp = _uniform_sphere(u[0], u[1])
    o = lp + lrad * usp
    # cosine-sample about the outward normal (= usp)
    r1 = 2.0 * np.pi * u[2]
    r2 = u[3]
    r2s = np.sqrt(r2)
    w = usp
    a = (np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.1
         else np.array([1.0, 0.0, 0.0]))
    uvec = _norm(np.cross(a, w))
    vvec = np.cross(w, uvec)
    d = uvec * (np.cos(r1) * r2s) + vvec * (np.sin(r1) * r2s) + w * np.sqrt(
        1.0 - r2)

    throughput = le * 0.25                       # device.cu:268
    slots = [None] * cfg.vpl_depth
    alive = True
    for depth in range(cfg.vpl_depth):
        if not alive:
            break
        hit, t, hid = _intersect(scene, o, d)
        if not hit:
            # environment VPL at the origin, inward normal, e/2
            slots[depth] = {
                "hp": o.copy(),
                "rad": le * 0.5,
                "nl": -(o - lp) / lrad,
            }
            break
        hp = o + t * d
        normal = _norm(hp - scene["p"][hid])
        dp = normal @ d
        nl = (-1.0 if dp > 0.0 else 1.0) * normal
        e = scene["e"][hid]
        if np.any(e != 0.0):
            break                                # hit an emitter: stop
        refl = int(scene["refl"][hid])
        albedo = scene["c"][hid]
        if refl == DIFF:
            tp = throughput * albedo
            slots[depth] = {"hp": hp.copy(), "rad": tp.copy(),
                            "nl": nl.copy()}
        # continue the walk with the shared scatter semantics
        su = tape[("scatter", depth)][:, lane]
        if refl == DIFF:
            r1 = 2.0 * np.pi * su[0]
            r2 = su[1]
            r2s = np.sqrt(r2)
            w = nl
            a = (np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.1
                 else np.array([1.0, 0.0, 0.0]))
            uvec = _norm(np.cross(a, w))
            vvec = np.cross(w, uvec)
            d = (uvec * (np.cos(r1) * r2s) + vvec * (np.sin(r1) * r2s)
                 + w * np.sqrt(1.0 - r2))
            mul = 1.0
        elif refl == SPEC:
            d = d - 2.0 * (normal @ d) * normal
            mul = 1.0
        else:
            refl_dir = d - 2.0 * (normal @ d) * normal
            into = (normal @ nl) > 0.0
            nnt = _NC / _NT if into else _NT / _NC
            ddn = d @ nl
            cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
            if cos2t < 0.0:
                d = refl_dir
                mul = 1.0
            else:
                kk = (1.0 if into else -1.0) * (ddn * nnt + np.sqrt(cos2t))
                trans = _norm(nnt * d - kk * normal)
                r0 = ((_NT - _NC) / (_NT + _NC)) ** 2
                c1 = 1.0 - (-ddn if into else trans @ normal)
                re = r0 + (1.0 - r0) * c1 ** 5
                p = 0.25 + 0.5 * re
                if su[2] < p:
                    d = refl_dir
                    mul = re / p
                else:
                    d = trans
                    mul = (1.0 - re) / (1.0 - p)
        o = hp
        throughput = throughput * albedo * mul
        alive = throughput.max() > cfg.throughput_tol
    return slots


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_to_np(scene) -> dict:
    """The scene's fields as float64 (``refl`` as it is) numpy arrays."""
    return {
        "rad": _host(scene.rad).astype(np.float64),
        "p": _host(scene.p).astype(np.float64),
        "e": _host(scene.e).astype(np.float64),
        "c": _host(scene.c).astype(np.float64),
        "refl": _host(scene.refl),
    }


def vpls_to_np(vpls) -> dict:
    """The VPL buffer's fields as float64 (``valid`` as it is) numpy
    arrays."""
    return {
        "hp": _host(vpls.hp).astype(np.float64),
        "rad": _host(vpls.rad).astype(np.float64),
        "nl": _host(vpls.nl).astype(np.float64),
        "valid": _host(vpls.valid),
    }
