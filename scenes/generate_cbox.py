"""Regenerate the bundled Cornell-box OBJ assets from the procedural
builder (scene/builtin.py). Run: python scenes/generate_cbox.py"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pathtracer.scene.builtin import cornell_box, write_obj  # noqa: E402


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    write_obj(cornell_box("quads"), os.path.join(here, "cbox_quads.obj"))
    write_obj(cornell_box("tris"), os.path.join(here, "cbox.obj"))
    write_obj(
        cornell_box("quads", mirror_tall_box=True),
        os.path.join(here, "cbox_mirror.obj"),
    )
    print("wrote cbox_quads.obj, cbox.obj, cbox_mirror.obj")


if __name__ == "__main__":
    main()
