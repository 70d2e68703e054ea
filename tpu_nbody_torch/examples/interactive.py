"""Interactive viewer — the Swing panel equivalent (requires matplotlib).

Replicates ``src/main/kotlin/NBodyPanel.kt``'s controls on top of the device
engine of the port; per-body data never leaves the device — the window
shows the device-rendered framebuffer.

Keys (same bindings and clamp ranges as the reference, NBodyPanel.kt:237-287):
  SPACE pause | R reset scene | C add cloud | D tree overlay | ESC quit
  Z/X theta -/+ (0.2..1.6)   O/P dt -/+ (-0.05..0.05, time reversal)
  K/L gravity -/+ (0..100)   Q/W disk radius | A/S disk body count
  arrows pan, scroll wheel zoom x1..x10 anchored at the cursor
  --fullscreen: real-screen-size framebuffer + WM fullscreen (Main.kt:5-37)
Mouse: left-drag adds a galaxy disk (drag vector = velocity), right-drag
adds a black hole, middle click clears the scene.

    python -m tpu_nbody_torch.examples.interactive [--solver bh|pm|allpairs]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="bh", choices=["bh", "pm", "allpairs"])
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--steps-per-frame", type=int, default=2)
    ap.add_argument("--fullscreen", action="store_true",
                    help="best-effort fullscreen: query the real screen "
                         "size, size the framebuffer to it, and toggle the "
                         "window manager's fullscreen mode — the reference "
                         "entry's fullscreen-exclusive + maximized fallback "
                         "(Main.kt:5-37, screen-size adaptation at 10-12)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    try:
        import matplotlib
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit(
            "matplotlib is required for the interactive viewer; for headless "
            "use run python -m tpu_nbody_torch.examples.collide_demo (GIF "
            "capture) instead.")

    import numpy as np

    if args.fullscreen:
        # Screen-size adaptation (Main.kt:10-12 overwrites Config.WIDTH_PX/
        # HEIGHT_PX from the real screen): size the device framebuffer to
        # the screen so one splat pixel = one display pixel.
        try:
            mgr = plt.figure().canvas.manager
            win = mgr.window
            try:        # Tk backend
                args.width = int(win.winfo_screenwidth())
                args.height = int(win.winfo_screenheight())
            except AttributeError:   # Qt backend
                scr = win.screen().size()
                args.width, args.height = int(scr.width()), int(scr.height())
            plt.close(mgr.canvas.figure)
        except Exception:
            pass     # keep --width/--height (maximized-window fallback)

    from tpu_nbody_torch import viewer as v
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.engine import Engine
    from tpu_nbody_torch.ops import render

    cfg = SimConfig(capacity=args.capacity, max_depth=12)
    eng = Engine(cfg, solver=args.solver, integrator="kdk_reuse",
                 device=args.device)
    # default two-disk scene, scaled down if capacity is small (leave half
    # the slots free for interactive disk/cloud insertion)
    n1 = min(10_000, args.capacity // 2 * 4 // 5)
    eng.reset_default_scene(n1=n1, n2=n1 // 4)
    hud = v.Hud()
    vp = v.Viewport(width=args.width, height=args.height,
                    world_w=cfg.world_w, world_h=cfg.world_h,
                    zoom=args.width / cfg.world_w, zoom_min=0.1)

    fig, ax = plt.subplots(figsize=(12, 4.5))
    fig.canvas.manager.set_window_title("tpu-nbody")
    if args.fullscreen:
        try:     # fullscreen-exclusive; falls back to a plain window like
            fig.canvas.manager.full_screen_toggle()  # Main.kt:24-35
        except Exception:
            pass
    im = ax.imshow(np.zeros((args.height, args.width, 3)))
    txt = ax.text(2, 2, "", va="top", color="#00ff00", fontsize=7,
                  family="monospace")
    ax.axis("off")
    state = {"drag": None, "cursor": None, "fps": 0.0, "frames": 0,
             "t0": time.time()}

    # D-key quadtree overlay: each quad's left + top edge, like
    # NBodyPanel.kt:327-344 (green outlines over the scene).
    from matplotlib.collections import LineCollection
    tree_lines = LineCollection([], colors="#00c000", linewidths=0.4,
                                alpha=0.6)
    ax.add_collection(tree_lines)
    # Drag preview: dashed velocity line + insertion-radius circle
    # (NBodyPanel.kt:310-324); the circle radius is hud.disk_r — the SAME
    # value the release handler inserts with, like the reference's uiR.
    from matplotlib.patches import Circle
    drag_line, = ax.plot([], [], "--", color="#00ff00", linewidth=1.0)
    drag_circle = Circle((0, 0), 1.0, fill=False, color="#00ff00",
                         linewidth=1.0, visible=False)
    ax.add_patch(drag_circle)

    def on_key(event):
        k = (event.key or "").upper()
        if k == "ESCAPE":
            plt.close(fig)
            return
        if k == "R":
            eng.reset_default_scene(n1=n1, n2=n1 // 4)
            return
        if k == "C":
            eng.add_cloud(5000, 0.5)
            return
        if k in ("LEFT", "RIGHT", "UP", "DOWN"):
            dx = {"LEFT": -10, "RIGHT": 10}.get(k, 0)
            dy = {"UP": -10, "DOWN": 10}.get(k, 0)
            vp.pan(dx, dy)
            return
        eng.params = hud.adjust(eng.params, k)

    def on_press(event):
        if event.xdata is None:
            return
        if event.button == 2:
            eng.clear()
        else:
            state["drag"] = (event.xdata, event.ydata, event.button)

    def on_motion(event):
        state["cursor"] = (event.xdata, event.ydata)

    def on_release(event):
        if state["drag"] is None or event.xdata is None:
            state["drag"] = None
            return
        sx, sy, button = state["drag"]
        state["drag"] = None
        vx = (event.xdata - sx) / vp.zoom  # VEL_PER_PIXEL = 1
        vy = (event.ydata - sy) / vp.zoom
        wx, wy = vp.screen_to_world(sx, sy)
        if button == 1:
            eng.add_galaxy_disk(wx, wy, r=hud.disk_r, n=hud.disk_n,
                                vx=vx, vy=vy)
        elif button == 3:
            eng.add_black_hole(wx, wy, vx=vx, vy=vy)

    def on_scroll(event):
        if event.xdata is not None:
            vp.wheel_zoom(event.xdata, event.ydata,
                          +1 if event.step > 0 else -1)

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)
    fig.canvas.mpl_connect("scroll_event", on_scroll)

    def tick(_):
        if not hud.paused:
            eng.step(args.steps_per_frame)
        fb = render.render_frame(
            eng.state.pos, eng.state.vel, eng.state.mass, eng.state.alive,
            width=args.width, height=args.height, view_x=vp.view_x,
            view_y=vp.view_y, zoom=vp.zoom, mode="speed",
            speed_scale=1 / 300.0, size_mass_scale=1e-4)
        im.set_data(render.to_uint8(fb).cpu().numpy())

        if hud.show_tree:
            center, side = eng.tree_boxes()
            # left + top edge of each quad, world -> screen
            x0 = (center[:, 0] - side / 2 - vp.view_x) * vp.zoom
            y0 = (center[:, 1] - side / 2 - vp.view_y) * vp.zoom
            x1 = x0 + side * vp.zoom
            y1 = y0 + side * vp.zoom
            segs = [[(x, ya, x, yb) for x, ya, yb in zip(x0, y0, y1)],
                    [(xa, y, xb, y) for xa, xb, y in zip(x0, x1, y0)]]
            tree_lines.set_segments(
                [((sx0, sy0), (sx1, sy1))
                 for part in segs for sx0, sy0, sx1, sy1 in part])
        else:
            tree_lines.set_segments([])

        if state["drag"] is not None and state["cursor"] is not None \
                and state["cursor"][0] is not None:
            sx, sy, button = state["drag"]
            cx, cy = state["cursor"]
            drag_line.set_data([sx, cx], [sy, cy])
            drag_circle.set_center((sx, sy))
            drag_circle.set_radius(hud.disk_r * vp.zoom)
            drag_circle.set_visible(button == 1)
        else:
            drag_line.set_data([], [])
            drag_circle.set_visible(False)

        state["frames"] += 1
        now = time.time()
        if now - state["t0"] >= 1.0:
            state["fps"] = state["frames"] / (now - state["t0"])
            state["frames"], state["t0"] = 0, now
        txt.set_text("\n".join(hud.lines(
            eng.params, int(eng.state.n_alive()), vp.zoom, state["fps"])))
        return [im, txt]

    from matplotlib.animation import FuncAnimation
    _anim = FuncAnimation(fig, tick, interval=1, blit=False,
                          cache_frame_data=False)
    plt.show()


if __name__ == "__main__":
    main()
