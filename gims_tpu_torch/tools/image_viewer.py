"""2x2 image-folder comparator.

Port of ``gims_tpu/tools/image_viewer.py`` (reference tools/image_viewer.py,
a tkinter GUI that shows the same-named image from up to four result
folders side by side): the headless mode writes the 2x2 composites, and the
GUI, where a display is available, shows them through tkinter's
``PhotoImage`` on PNG bytes. Images are read, resized (INTER_LINEAR) and
labelled (``FONT_HERSHEY_SIMPLEX`` at 0.7, thickness 2) as OpenCV does it,
with the port's ``core/image_io.py``, ``core/imgproc.py`` and
``core/drawing.py``: the grid equals the JAX package's to the byte.

    python -m gims_tpu_torch.tools.image_viewer out/gims out/dgims --headless grids/
"""

from __future__ import annotations

import argparse
import base64
import os
from pathlib import Path

import numpy as np

from gims_tpu_torch.core import drawing, image_io, imgproc

SUFFIXES = (".jpg", ".png", ".jpeg")


def list_common_images(folders):
    """Names of the images that every folder holds, sorted."""
    sets = [{p.name for p in Path(folder).iterdir() if p.suffix.lower() in SUFFIXES}
            for folder in folders]
    return sorted(set.intersection(*sets) if sets else set())


def compose_grid(folders, name, cell=(480, 360)):
    """(2 * cell[1], 2 * cell[0], 3) uint8: the first four folders' `name`,
    each resized to `cell` and labelled with its folder's name."""
    tiles = []
    for folder in folders[:4]:
        img = image_io.imread(str(Path(folder) / name))
        if img is None:
            img = np.zeros((cell[1], cell[0], 3), np.uint8)
        img = imgproc.resize(img, cell)
        drawing.put_text(img, Path(folder).name, (8, 24), drawing.FONT_HERSHEY_SIMPLEX, 0.7,
                         (0, 255, 0), 2)
        tiles.append(img)
    while len(tiles) < 4:
        tiles.append(np.zeros((cell[1], cell[0], 3), np.uint8))
    top = np.concatenate(tiles[:2], axis=1)
    bottom = np.concatenate(tiles[2:4], axis=1)
    return np.concatenate([top, bottom], axis=0)


def run_headless(folders, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    names = list_common_images(folders)
    for name in names:
        image_io.imwrite(str(Path(out_dir) / name), compose_grid(folders, name))
    print(f"wrote {len(names)} composites to {out_dir}")


def run_gui(folders):
    import tkinter as tk

    names = list_common_images(folders)
    if not names:
        print("no common images")
        return
    root = tk.Tk()
    root.title("GIMS image viewer")
    label = tk.Label(root)
    label.pack()
    title = tk.StringVar(value=names[0])
    tk.Label(root, textvariable=title).pack()
    state = {"i": 0}

    def show():
        png = image_io.encode_png(compose_grid(folders, names[state["i"]]))
        photo = tk.PhotoImage(data=base64.b64encode(png).decode(), format="png")
        label.configure(image=photo)
        label.image = photo
        title.set(f"[{state['i'] + 1}/{len(names)}] {names[state['i']]}")

    def step(d):
        state["i"] = (state["i"] + d) % len(names)
        show()

    root.bind("<Right>", lambda e: step(1))
    root.bind("<Left>", lambda e: step(-1))
    show()
    root.mainloop()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("folders", nargs="+")
    parser.add_argument("--headless", type=str, default=None,
                        help="write 2x2 composites to this directory")
    args = parser.parse_args(argv)
    if args.headless:
        run_headless(args.folders, args.headless)
    else:
        try:
            run_gui(args.folders)
        except Exception as e:  # noqa: BLE001
            print(f"GUI unavailable ({e}); use --headless OUT_DIR")


if __name__ == "__main__":
    main()
