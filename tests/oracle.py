"""Scalar per-pixel oracle tracer — test-only.

An INDEPENDENT, deliberately-naive transcription of the reference's WGSL
semantics (pt.wgsl / random.wgsl / blit.wgsl) into scalar Python/NumPy f32,
one pixel at a time. It shares no code with the vectorized JAX implementation
and exists purely so tests can catch vectorization bugs: for identical seeds
the wavefront tracer must produce the same per-pixel radiance (within f32
reassociation noise) and the exact same RNG draw schedule.

Everything is np.float32 scalars/vec3s (NumPy 2 NEP50 keeps f32 in mixed
scalar ops), and uint32 wraparound is used for the RNG just like WGSL.
"""

from __future__ import annotations

import numpy as np

np.seterr(all="ignore")

F = np.float32
U = np.uint32
EPSILON = F(1e-6)
PI = F(3.14159265359)
MAX_BOUNCES = 8
DO_MIS = True

LIGHT_EMISSIVE = 0
LIGHT_DIRECTIONAL = 1
LIGHT_POINT = 2


def vec3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], np.float32)


def dot(a, b):
    return F(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a, b):
    return vec3(
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return F(np.sqrt(dot(a, a)))


def normalize(a):
    return a / length(a)


def reflect(e, n):
    return e - F(2.0) * dot(e, n) * n


def refract(e, n, eta):
    cos_i = dot(n, e)
    k = F(1.0) - eta * eta * (F(1.0) - cos_i * cos_i)
    if k < 0.0:
        return vec3()
    return eta * e - (eta * cos_i + F(np.sqrt(k))) * n


def mix(x, y, a):
    return x * (F(1.0) - a) + y * a


class Rng:
    """random.wgsl transcription."""

    def __init__(self):
        self.state = U(0)
        # Values that replace the next draws while the state still
        # advances (the bounce-0 low-discrepancy extension,
        # ops/bsdf.py::sample_bsdf ``override``).
        self.queue = []

    def init(self, x, y, frame):
        self.state = U(U(x) + U(y) * U(1000) + U(frame) * U(100000))

    def rand(self):
        self.state = U(self.state * U(747796405) + U(2891336453))
        s = self.state
        word = U(((s >> U((s >> U(28)) + U(4))) ^ s) * U(277803737))
        word = U((word >> U(22)) ^ word)
        if self.queue:
            return F(self.queue.pop(0))
        return F(F(word) / F(4294967295.0))

    def rand_int(self, lo, hi):
        return int(U(lo) + U(self.rand() * F(hi - lo + 1)))


class Oracle:
    """Holds a SceneArrays + camera dict and traces single pixels."""

    def __init__(self, scene, camera, width, height,
                 max_bounces=MAX_BOUNCES, do_mis=DO_MIS, bounce0=None):
        """``bounce0``: optional (3, width*height) [lobe, r1, r2] values
        replacing the first bounce's three BSDF draws (opt-in extension)."""
        self.s = scene
        self.cam = camera
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.do_mis = do_mis
        self.bounce0 = None if bounce0 is None else np.asarray(bounce0, F)
        self._lane = 0
        self.rng = Rng()
        atlas = scene.atlas
        self.atlas = None if atlas is None else np.asarray(atlas, np.float32)

    # --- textures (pt.wgsl:112-120) -----------------------------------------
    def texture_color(self, rect, uv, fallback):
        x, y, w, h = (F(v) for v in rect)
        if w == 0.0 or h == 0.0 or self.atlas is None:
            return np.asarray(fallback, np.float32)
        ax = x + F(np.fmod(uv[0], F(1.0))) * w
        ay = y + F(np.fmod(uv[1], F(1.0))) * h
        ah, aw = self.atlas.shape[0], self.atlas.shape[1]
        ix = min(max(int(ax), 0), aw - 1)
        iy = min(max(int(ay), 0), ah - 1)
        return self.atlas[iy, ix].astype(np.float32)

    # --- intersection (pt.wgsl:123-296) --------------------------------------
    def ray_triangle(self, ro, rd, i):
        s = self.s
        v0, v1, v2 = s.tri_v0[i], s.tri_v1[i], s.tri_v2[i]
        edge1 = v1 - v0
        edge2 = v2 - v0
        h = cross(rd, edge2)
        a = dot(edge1, h)
        if abs(a) < EPSILON:
            return None
        f = F(1.0) / a
        svec = ro - v0
        u = f * dot(svec, h)
        if u < 0.0 or u > 1.0:
            return None
        q = cross(svec, edge1)
        v = f * dot(rd, q)
        if v < 0.0 or u + v > 1.0:
            return None
        t = f * dot(edge2, q)
        if not (t > EPSILON):
            return None

        hit = {}
        hit["t"] = F(t)
        hit["position"] = ro + rd * t
        w = F(1.0) - u - v
        geometry_normal = normalize(cross(edge1, edge2))
        interp_normal = normalize(s.tri_n0[i] * w + s.tri_n1[i] * u + s.tri_n2[i] * v)

        duv1 = s.tri_uv1[i] - s.tri_uv0[i]
        duv2 = s.tri_uv2[i] - s.tri_uv0[i]
        r = F(1.0) / (duv1[0] * duv2[1] - duv1[1] * duv2[0])
        tangent = normalize((edge1 * duv2[1] - edge2 * duv1[1]) * r)
        n = interp_normal
        tv = normalize(tangent - n * dot(n, tangent))
        bv = normalize(cross(n, tv))

        hit["uv"] = (s.tri_uv0[i] * w + s.tri_uv1[i] * u + s.tri_uv2[i] * v).astype(F)
        mi = int(s.tri_mat[i])
        hit["material_index"] = mi
        hit["is_front"] = bool(dot(geometry_normal, rd) < 0.0)

        albedo_value = self.texture_color(
            s.mat_albedo_rect[mi], hit["uv"], (1.0, 1.0, 1.0, 1.0)
        )
        hit["albedo"] = (albedo_value[0:3] * s.mat_base_color[mi]).astype(F)
        hit["alpha"] = F(albedo_value[3])
        pbr_value = self.texture_color(
            s.mat_pbr_rect[mi], hit["uv"], (1.0, 1.0, 1.0, 1.0)
        )
        hit["metallic"] = F(pbr_value[2] * s.mat_metallic[mi])
        hit["roughness"] = F(max(pbr_value[1] * s.mat_roughness[mi], F(0.04)))
        hit["transmission"] = F(s.mat_transmission[mi])
        hit["ior"] = F(s.mat_ior[mi])
        emissive_value = self.texture_color(
            s.mat_emissive_rect[mi], hit["uv"], (1.0, 1.0, 1.0, 1.0)
        )
        hit["emission"] = (emissive_value[0:3] * s.mat_emission[mi]).astype(F)
        hit["emissive_strength"] = F(s.mat_emissive_strength[mi])

        normal_map = self.texture_color(
            s.mat_normal_rect[mi], hit["uv"], (0.5, 0.5, 1.0, 1.0)
        )[0:3]
        if normal_map[0] != 0.5 or normal_map[1] != 0.5 or normal_map[2] != 1.0:
            tn = normal_map * F(2.0) - F(1.0)
            hit["normal"] = normalize(tv * tn[0] + bv * tn[1] + n * tn[2])
        else:
            hit["normal"] = interp_normal
        return hit

    def scene_intersect(self, ro, rd):
        closest = None
        for i in range(self.s.num_triangles):
            hit = self.ray_triangle(ro, rd, i)
            if hit is not None and (closest is None or hit["t"] < closest["t"]):
                closest = hit
        return closest

    # --- BSDF (pt.wgsl:299-364, 492-634) --------------------------------------
    def construct_tbn(self, n):
        t = vec3(1.0, 0.0, 0.0)
        if abs(n[0]) > 0.9:
            t = vec3(0.0, 1.0, 0.0)
        b = normalize(cross(n, t))
        t = normalize(cross(b, n))
        return t, b, n

    def random_cosine_direction(self):
        r1 = self.rng.rand()
        r2 = self.rng.rand()
        z = F(np.sqrt(F(1.0) - r2))
        phi = F(2.0) * PI * r1
        x = F(np.cos(phi) * np.sqrt(r2))
        y = F(np.sin(phi) * np.sqrt(r2))
        return vec3(x, y, z)

    def sample_ggx_normal(self, normal, roughness):
        r1 = self.rng.rand()
        r2 = self.rng.rand()
        a = roughness * roughness
        phi = F(2.0) * PI * r1
        cos_t = F(np.sqrt((F(1.0) - r2) / (F(1.0) + (a * a - F(1.0)) * r2)))
        sin_t = F(np.sqrt(F(1.0) - cos_t * cos_t))
        local = vec3(sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t)
        t, b, n = self.construct_tbn(normal)
        return normalize(t * local[0] + b * local[1] + n * local[2])

    @staticmethod
    def reflectance(cos_theta, eta):
        r0 = (F(1.0) - eta) / (F(1.0) + eta)
        r0 = r0 * r0
        return F(r0 + (F(1.0) - r0) * np.power(F(1.0) - cos_theta, F(5.0)))

    @staticmethod
    def distribution_ggx(n, h, roughness):
        a = roughness * roughness
        a2 = a * a
        ndoth = max(dot(n, h), F(0.0))
        denom = ndoth * ndoth * (a2 - F(1.0)) + F(1.0)
        return F(max(a2 / (PI * denom * denom), F(0.0)))

    @staticmethod
    def geometry_schlick_ggx(ndotv, roughness):
        r = roughness + F(1.0)
        k = (r * r) / F(8.0)
        return F(ndotv / (ndotv * (F(1.0) - k) + k))

    def geometry_smith(self, n, v, l, roughness):
        ndotv = max(dot(n, v), F(0.0))
        ndotl = max(dot(n, l), F(0.0))
        return F(
            self.geometry_schlick_ggx(ndotl, roughness)
            * self.geometry_schlick_ggx(ndotv, roughness)
        )

    def sample_bsdf(self, hit, rd, front):
        v = -normalize(rd)
        diffuse_prob = (F(1.0) - hit["metallic"]) * (F(1.0) - hit["transmission"])
        specular_prob = hit["metallic"]
        r = self.rng.rand()
        if r < diffuse_prob:
            local = self.random_cosine_direction()
            t, b, n = self.construct_tbn(hit["normal"])
            return t * local[0] + b * local[1] + n * local[2]
        elif r < diffuse_prob + specular_prob:
            roughness = max(hit["roughness"], F(0.04))
            n = self.sample_ggx_normal(hit["normal"], roughness)
            return reflect(-v, n)
        else:
            eta = F(1.0) / hit["ior"] if front else hit["ior"]
            roughness = max(hit["roughness"], F(0.04))
            n = self.sample_ggx_normal(hit["normal"], roughness)
            n = n if front else -n
            cos_theta = dot(n, v)
            sin_theta = F(np.sqrt(F(1.0) - cos_theta * cos_theta))
            cannot_refract = eta * sin_theta > 1.0
            fr = self.reflectance(abs(cos_theta), eta)
            if cannot_refract or (self.rng.rand() < fr):
                return reflect(-v, n)
            return refract(-v, n, eta)

    def eval_bsdf(self, hit, normal, v, l, front):
        h = normalize(v + l)
        ndotl = max(dot(normal, l), F(0.0))
        ndotv = max(dot(normal, v), F(0.0))
        ndoth = max(dot(normal, h), F(0.0))
        vdoth = max(dot(v, h), F(0.0))

        f0 = mix(vec3(0.04, 0.04, 0.04), hit["albedo"], hit["metallic"])
        fr = f0 + (F(1.0) - f0) * F(np.power(F(1.0) - vdoth, F(5.0)))
        g = self.geometry_smith(normal, v, l, hit["roughness"])
        d = self.distribution_ggx(normal, h, hit["roughness"])

        kd = (F(1.0) - fr) * (F(1.0) - hit["transmission"])
        diffuse = kd * hit["albedo"] / PI
        specular = fr * g * d / max(F(4.0) * ndotv * ndotl, EPSILON)

        if hit["transmission"] > 0.0:
            eta = F(1.0) / hit["ior"] if front else hit["ior"]
            cos_theta = dot(normal, v)
            f_t = self.reflectance(abs(cos_theta), eta)
            bsdf = (F(1.0) - f_t) * hit["albedo"]
            pdf = (F(1.0) - hit["metallic"]) * hit["transmission"]
        else:
            bsdf = (diffuse + specular) * ndotl
            diffuse_prob = (F(1.0) - hit["metallic"]) * (F(1.0) - hit["transmission"])
            specular_prob = hit["metallic"]
            diffuse_pdf = ndotl / PI
            specular_pdf = d * ndoth / (F(4.0) * vdoth)
            pdf = diffuse_prob * diffuse_pdf + specular_prob * specular_pdf

        return bsdf.astype(F), F(max(pdf, EPSILON))

    @staticmethod
    def power_heuristic(nf, f_pdf, ng, g_pdf):
        f = nf * f_pdf
        g = ng * g_pdf
        return F((f * f) / (f * f + g * g))

    # --- lights (pt.wgsl:366-489) ----------------------------------------------
    def sample_light(self, hit_position):
        s = self.s
        n_lights = s.num_lights
        li = self.rng.rand_int(0, n_lights - 1)
        li = min(li, n_lights - 1)
        ltype = int(s.light_type[li])
        color = s.light_color[li]
        intensity = F(s.light_intensity[li])

        zero = {"intensity": vec3(), "wi": vec3(), "pdf": F(0.0), "type": ltype}

        if ltype == LIGHT_DIRECTIONAL:
            wi = normalize(-s.light_position[li])
            shadow = self.scene_intersect(hit_position + wi * EPSILON, wi)
            if shadow is not None and shadow["t"] > 0.0:
                return {**zero, "wi": wi}
            return {
                "intensity": color * intensity,
                "wi": wi,
                "pdf": F(F(1.0) / F(n_lights) * F(1000.0)),
                "type": ltype,
            }
        elif ltype == LIGHT_POINT:
            to_light = s.light_position[li] - hit_position
            dist = length(to_light)
            if dist > 100.0:
                return zero
            wi = to_light / dist
            shadow = self.scene_intersect(hit_position + wi * EPSILON, wi)
            if shadow is not None and shadow["t"] < dist - EPSILON * F(2.0):
                return {**zero, "wi": wi}
            att = F(1.0) / (dist * dist)
            return {
                "intensity": color * intensity * att,
                "wi": wi,
                "pdf": F(F(1.0) / F(n_lights) * F(10000.0)),
                "type": ltype,
            }
        else:
            ti = int(s.light_tri[li])
            r1 = self.rng.rand()
            r2 = self.rng.rand()
            u = F(1.0) - F(np.sqrt(r1))
            v = r2 * F(np.sqrt(r1))
            w = F(1.0) - u - v
            v0, v1, v2 = s.tri_v0[ti], s.tri_v1[ti], s.tri_v2[ti]
            light_pos = v0 * w + v1 * u + v2 * v
            normal = normalize(s.tri_n0[ti] * w + s.tri_n1[ti] * u + s.tri_n2[ti] * v)
            to_light = light_pos - hit_position
            dist = length(to_light)
            wi = to_light / dist
            shadow = self.scene_intersect(hit_position + wi * EPSILON, wi)
            if shadow is not None and shadow["t"] < dist - EPSILON * F(2.0):
                return {**zero, "wi": wi}
            e1 = v1 - v0
            e2 = v2 - v0
            area = length(cross(e1, e2)) * F(0.5)
            cos_theta = abs(dot(normal, -wi))
            pdf = (
                (F(1.0) / F(n_lights))
                * (F(1.0) / area)
                * (dist * dist / max(cos_theta, EPSILON))
            )
            return {
                "intensity": color * intensity,
                "wi": wi,
                "pdf": F(pdf),
                "type": ltype,
            }

    # --- trace (pt.wgsl:638-709) ---------------------------------------------
    def trace(self, ro, rd):
        throughput = vec3(1.0, 1.0, 1.0)
        result = vec3()
        cur_o, cur_d = ro, rd

        for bounce in range(self.max_bounces):
            hit = self.scene_intersect(cur_o, cur_d)
            if hit is None:
                break
            if np.any(hit["emission"] > 0.0):
                distance = hit["t"]
                att = F(1.0) / (F(1.0) + distance * distance)
                result = result + throughput * hit["emission"] * hit[
                    "emissive_strength"
                ] * att
                break

            if self.do_mis and hit["transmission"] == 0.0 and hit["is_front"]:
                ls = self.sample_light(hit["position"])
                if ls["pdf"] > 0.0:
                    v = -normalize(cur_d)
                    bsdf, bsdf_pdf = self.eval_bsdf(
                        hit, hit["normal"], v, ls["wi"], hit["is_front"]
                    )
                    mw = self.power_heuristic(F(1.0), ls["pdf"], F(1.0), bsdf_pdf)
                    direct = ls["intensity"] * bsdf * mw / max(ls["pdf"], EPSILON)
                    result = result + throughput * direct

            if bounce == 0 and self.bounce0 is not None:
                self.rng.queue = list(self.bounce0[:, self._lane])
            bsdf_dir = self.sample_bsdf(hit, cur_d, hit["is_front"])
            self.rng.queue = []
            bsdf, pdf = self.eval_bsdf(
                hit, hit["normal"], -normalize(cur_d), bsdf_dir, hit["is_front"]
            )
            if pdf <= 0.0:
                break

            cur_o = hit["position"] + bsdf_dir * EPSILON
            cur_d = normalize(bsdf_dir)
            throughput = throughput * bsdf / max(pdf, EPSILON)

            if bounce > 2:
                p = F(max(throughput[0], max(throughput[1], throughput[2])))
                if self.rng.rand() > p:
                    break
                throughput = throughput / p

        return result

    # --- main (pt.wgsl:712-762) -------------------------------------------------
    def render_pixel(self, x, y, frame):
        """One 1-spp sample for pixel (x, y) at frame index ``frame``.
        Returns the pre-accumulation clamped color."""
        cam = self.cam
        self.rng.init(x, y, frame)
        self._lane = y * self.width + x
        px = F(x) + self.rng.rand()
        py = F(y) + self.rng.rand()
        u = (px / F(self.width)) * F(2.0) - F(1.0)
        v = (py / F(self.height)) * F(2.0) - F(1.0)

        tan_half = F(np.tan(F(cam["fov"]) * F(0.5)))
        rd = normalize(
            cam["forward"]
            + u * cam["right"] * tan_half * F(cam["aspect"])
            + v * cam["up"] * tan_half
        )
        ro = cam["position"].astype(F)

        if cam["aperture"] > 0.0:
            focal = cam["position"] + rd * F(cam["focus_distance"])
            r = F(np.sqrt(self.rng.rand())) * F(cam["aperture"])
            theta = self.rng.rand() * F(2.0) * PI
            offset = cam["right"] * (r * F(np.cos(theta))) + cam["up"] * (
                r * F(np.sin(theta))
            )
            ro = (cam["position"] + offset).astype(F)
            rd = normalize(focal - ro)

        color = self.trace(ro, rd)
        return np.minimum(color, F(2.5))

    def render(self, spp, pixels=None):
        """Running-mean accumulation over ``spp`` frames for the given pixel
        list (default: all). Returns dict {(x, y): vec3}."""
        if pixels is None:
            pixels = [(x, y) for y in range(self.height) for x in range(self.width)]
        accum = {p: vec3() for p in pixels}
        for frame in range(spp):
            for p in pixels:
                c = self.render_pixel(p[0], p[1], frame)
                if frame > 0:
                    t = F(1.0) / F(frame + 1)
                    accum[p] = mix(accum[p], c, t)
                else:
                    accum[p] = c
        return accum


PROBE_PIXELS = [(2, 2), (8, 8), (13, 4), (5, 12), (12, 12), (6, 10),
                (3, 7), (10, 2), (14, 14), (1, 13)]


def trace_vs_oracle(scene, scene_dev, size, max_bounces=8, do_mis=True,
                    lds=False, frame=0):
    """Trace a size x size frame through the XLA bounce loop
    (ops/trace.py) and count, over PROBE_PIXELS, (a) pixels whose final
    RNG state differs from this oracle's (razor-tie branch flips) and (b)
    state-synced pixels whose radiance is off by more than 2e-3 (a
    knife-edge occlusion flips radiance without consuming randomness).
    ``lds`` feeds the same bounce-0 low-discrepancy values to both."""
    import jax.numpy as jnp

    from wgpu_path_tracing_tpu.ops import camera_rays as CAM
    from wgpu_path_tracing_tpu.ops import trace as TRACE
    from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
    from wgpu_path_tracing_tpu.render.camera import Camera
    from wgpu_path_tracing_tpu.render.pipeline import camera_device

    camera = Camera(width=size, height=size, aspect=1.0)
    cam_np = {
        "position": camera.position, "forward": camera.forward,
        "right": camera.right, "up": camera.up,
        "fov": np.float32(camera.fov), "aspect": np.float32(camera.aspect),
        "aperture": np.float32(camera.aperture),
        "focus_distance": np.float32(camera.focus_distance),
    }
    cam = camera_device(camera.as_pytree(), size, size)
    x, y = CAM.pixel_grid(size, size)
    ro, rd, state = CAM.generate_rays(cam, x, y, jnp.int32(frame),
                                      use_dof=True)
    lds0 = CAM.bounce0_lds(x, y, jnp.int32(frame)) if lds else None
    oracle = Oracle(scene, cam_np, size, size, max_bounces=max_bounces,
                    do_mis=do_mis,
                    bounce0=None if lds0 is None else np.asarray(lds0))
    ch = make_closest_hit(scene_dev, "auto", 512, 4)
    rad, st, _ = TRACE.trace(
        scene_dev, ch, ro, rd, state, max_bounces=max_bounces,
        do_mis=do_mis and scene.num_lights > 0, num_lights=scene.num_lights,
        lds0=lds0,
    )
    rad, st = np.asarray(rad), np.asarray(st)
    flips = off = 0
    for (px, py) in PROBE_PIXELS:
        lane = py * size + px
        expected = oracle.render_pixel(px, py, frame)
        if int(st[lane]) != int(oracle.rng.state):
            flips += 1
        elif not np.allclose(np.minimum(rad[lane], 2.5), expected,
                             rtol=2e-3, atol=2e-3):
            off += 1
    return flips, off

