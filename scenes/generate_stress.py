"""Generate the large-scene stress scene (stress100k): a ~100k-
triangle displaced sphere as binary PLY, wrapped in a .pbrt scene with a
ground plane and an area light. Run: python scenes/generate_stress.py"""

import os
import struct
import sys

import numpy as np


def displaced_sphere(n_theta=226, n_phi=226, seed=7):
    """Lat-long sphere with low-frequency radial displacement:
    2 * (n_theta-1) * (n_phi) triangles ~= 101k for 226x226."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    phi = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    # smooth displacement from a few random spherical harmonics-ish waves
    disp = np.zeros_like(tt)
    for _ in range(6):
        a, b = rng.integers(1, 7, 2)
        ph = rng.uniform(0, 2 * np.pi)
        disp += rng.uniform(0.02, 0.08) * np.sin(a * tt + ph) * np.cos(
            b * pp
        )
    r = 1.0 + disp
    x = r * np.sin(tt) * np.cos(pp)
    y = r * np.cos(tt)
    z = r * np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            a = i * n_phi + j
            b = i * n_phi + j2
            c = (i + 1) * n_phi + j2
            d = (i + 1) * n_phi + j
            faces.append((a, b, c))
            faces.append((a, c, d))
    return verts, np.asarray(faces, np.int32)


def write_ply_binary(path, verts, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        f.write(verts.astype("<f4").tobytes())
        body = bytearray()
        for a, b, c in faces:
            body += struct.pack("<Biii", 3, a, b, c)
        f.write(bytes(body))


PBRT_TEMPLATE = """# generated stress scene (~{ntris} triangles)
LookAt 0 1.2 4.2  0 0.6 0  0 1 0
Camera "perspective" "float fov" [35]

WorldBegin

# area light overhead
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [18 18 18]
  Material "matte" "rgb Kd" [0.8 0.8 0.8]
  Shape "trianglemesh"
    "point3 P" [-1 3.2 -1  1 3.2 -1  1 3.2 1  -1 3.2 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd

# ground plane
Material "matte" "rgb Kd" [0.65 0.65 0.65]
Shape "trianglemesh"
  "point3 P" [-8 -1.1 -8  8 -1.1 -8  8 -1.1 8  -8 -1.1 8]
  "integer indices" [0 2 1  0 3 2]

# displaced sphere (~{ntris} triangles)
Material "matte" "rgb Kd" [0.75 0.45 0.25]
AttributeBegin
  Translate 0 0.3 0
  Shape "plymesh" "string filename" ["sphere100k.ply"]
AttributeEnd
"""


def generate(out_dir, tag="100k", n=226):
    """Write sphere{tag}.ply + stress{tag}.pbrt into out_dir. n=226
    gives ~101k triangles (the committed config-#4 scene); n=709 gives
    ~1.004M (generated on demand by benchmarks/stress1m.py — the 19 MB
    PLY is not committed)."""
    verts, faces = displaced_sphere(n_theta=n, n_phi=n)
    ply = f"sphere{tag}.ply"
    write_ply_binary(os.path.join(out_dir, ply), verts, faces)
    pbrt = os.path.join(out_dir, f"stress{tag}.pbrt")
    with open(pbrt, "w") as f:
        f.write(
            PBRT_TEMPLATE.format(ntris=len(faces)).replace(
                "sphere100k.ply", ply
            )
        )
    print(f"wrote {ply} ({len(faces)} tris) + stress{tag}.pbrt")
    return pbrt


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    tag = sys.argv[1] if len(sys.argv) > 1 else "100k"
    generate(here, tag=tag, n=226 if tag == "100k" else 709)


if __name__ == "__main__":
    main()
