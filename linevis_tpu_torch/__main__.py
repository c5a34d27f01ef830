"""Command-line front end: `python -m linevis_tpu_torch <command> ...`.

Counterpart of `linevis_tpu/__main__.py`. The reference is a GUI
application whose CLI surface is thin (`src/Main.cpp:87-107`: `--perf`
toggles the automatic performance measurement mode, plus window flags);
headless, the same capabilities map onto subcommands:

  datasets  list the entries of a datasets.json registry
            (`src/MainApp.cpp` dataset menu)
  render    load a dataset, pick a renderer + settings, write a PNG
            (the interactive view's load->render->present path)
  replay    execute a `g.*` replay script (`ReplayWidget.cpp`; reference
            scripts from Data/ReplayScripts run via the compat shims)
  perf      the `--perf` mode: drive the test-mode matrices over a
            camera flight and write the benchmark CSVs
            (`AutomaticPerformanceMeasurer.cpp`)
  view      the live-orbit browser viewer (`app.py`)

Every command but `datasets` draws on `--device` (default `cuda`, the
card; `--device cpu` runs the kernels' plain versions). `--set key=value`
mirrors the reference's SettingsMap key/value strings (InternalState.hpp);
values keep their string form and are parsed by the consumer exactly like
settings.txt / replay `set_rendering_algorithm_settings` entries.
"""

from __future__ import annotations

import argparse
import os
import sys


def _settings_map(pairs):
    from linevis_tpu_torch.core.settings import SettingsMap

    s = SettingsMap()
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        s.add_key_value(k.strip(), v.strip())
    return s


def _make_loader(args):
    """Dataset-name resolver: datasets.json entry name if a registry is
    given (or found next to the file), else a bare file path."""
    from linevis_tpu_torch.scene.factory import load_line_data

    registry = None
    base_dir = ""
    if getattr(args, "datasets_json", None):
        from linevis_tpu_torch.loaders.dataset_list import load_dataset_list

        root = load_dataset_list(args.datasets_json)
        base_dir = os.path.dirname(os.path.abspath(args.datasets_json))
        registry = {leaf.name: leaf for leaf in root.flat_leaves()}

    def loader(name: str):
        if registry is not None and name in registry:
            return load_line_data(registry[name], base_dir=base_dir)
        return load_line_data(name)

    return loader


def _device_name(device) -> str:
    import torch

    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def _camera(args):
    from linevis_tpu_torch.render.camera import Camera

    kw = dict(width=args.width, height=args.height)
    if args.camera_position:
        kw["position"] = tuple(args.camera_position)
    if args.camera_look_at:
        kw["look_at_point"] = tuple(args.camera_look_at)
    if args.fovy:
        kw["fovy"] = float(args.fovy)
    return Camera(**kw)


def cmd_datasets(args) -> int:
    from linevis_tpu_torch.loaders.dataset_list import load_dataset_list

    root = load_dataset_list(args.datasets_json)
    for leaf in root.flat_leaves():
        print(f"{leaf.name}\t{leaf.type}\t{';'.join(leaf.filenames)}")
    return 0


def cmd_render(args) -> int:
    from linevis_tpu_torch.render.framebuffer import save_png
    from linevis_tpu_torch.render.renderer import create_renderer

    loader = _make_loader(args)
    line_data = loader(args.dataset)
    if args.dataset_set:
        line_data.set_new_settings(_settings_map(args.dataset_set))
    renderer = create_renderer(args.renderer, _settings_map(args.set), device=args.device)
    renderer.set_line_data(line_data)
    if args.transfer_function:
        from linevis_tpu_torch.render.transfer_function import TransferFunction

        renderer.set_transfer_function(
            TransferFunction.from_xml(args.transfer_function)
        )
    cam = _camera(args)
    img = renderer.render(cam)
    for _ in range(max(args.accumulate - 1, 0)):
        img = renderer.render(cam)  # accumulating modes (RT/RTAO/VPT)
    save_png(args.output, img)
    print(f"wrote {args.output} [{args.renderer}, "
          f"{args.width}x{args.height}, {_device_name(args.device)}]")
    return 0


def cmd_replay(args) -> int:
    from linevis_tpu_torch.automation.replay import ReplayWidget

    widget = ReplayWidget(
        _make_loader(args), fps=args.fps, output_dir=args.output_dir,
        device=args.device,
    )
    widget.render_every_frame = not args.final_frames_only
    widget.load_script(args.script)
    frames = widget.run(width=args.width, height=args.height)
    print(f"replay done: {frames} frames")
    return 0


def cmd_view(args) -> int:
    from linevis_tpu_torch.app import LineVisApp, serve

    loader = _make_loader(args)
    line_data = loader(args.dataset)
    if args.dataset_set:
        line_data.set_new_settings(_settings_map(args.dataset_set))
    app = LineVisApp(
        line_data, width=args.width, height=args.height,
        mode=args.renderer, accumulate=args.accumulate, device=args.device,
    )
    serve(app, port=args.port)
    return 0


def cmd_perf(args) -> int:
    from linevis_tpu_torch.automation.perf import (
        AutomaticPerformanceMeasurer,
        get_test_modes,
        get_test_modes_oit,
    )

    size = (args.width, args.height)
    modes = (
        get_test_modes_oit(args.dataset, size)
        if args.oit
        else get_test_modes(args.dataset, size)
    )
    if args.mode_filter:
        modes = [m for m in modes if args.mode_filter in m.name]
        if not modes:
            raise SystemExit(f"no test mode matches {args.mode_filter!r}")
    measurer = AutomaticPerformanceMeasurer(
        modes, _make_loader(args), csv_path=args.csv,
        flight_seconds=args.flight_seconds, fps_target=args.fps,
        device=args.device,
    )
    rows = measurer.run()
    if args.per_frame_csv:
        measurer.write_per_frame_csv(args.per_frame_csv)
    for r in rows:
        print(f"{r['State Name']}: {r['Average FPS']} FPS avg "
              f"({r['Average Time (ms)']} ms)")
    print(f"wrote {args.csv}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m linevis_tpu_torch",
        description="Dense-line visualization on PyTorch and CUDA "
                    "(LineVis feature parity, headless)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser("datasets", help="list datasets.json entries")
    d.add_argument("datasets_json")
    d.set_defaults(fn=cmd_datasets)

    def add_common(s, size=True):
        s.add_argument("--datasets-json", default=None,
                       help="registry for dataset names (else file paths)")
        if size:
            s.add_argument("--width", type=int, default=1920)
            s.add_argument("--height", type=int, default=1080)
        s.add_argument("--device", default="cuda",
                       help='device to draw on: "cuda" (the card) or "cpu"')

    r = sub.add_parser("render", help="render one frame to a PNG")
    r.add_argument("dataset", help="datasets.json name or dataset file")
    r.add_argument("--renderer", default="Opaque",
                   help='rendering mode name (e.g. "Opaque", '
                        '"Multi-Layer Alpha Blending", "Vulkan Ray Tracer")')
    r.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="renderer SettingsMap entry (repeatable)")
    r.add_argument("--dataset-set", action="append", metavar="KEY=VALUE",
                   help="dataset SettingsMap entry (repeatable)")
    r.add_argument("--transfer-function", default=None,
                   help=".xml transfer function file")
    r.add_argument("--camera-position", type=float, nargs=3, default=None)
    r.add_argument("--camera-look-at", type=float, nargs=3, default=None)
    r.add_argument("--fovy", type=float, default=None)
    r.add_argument("--accumulate", type=int, default=1,
                   help="render N frames from the fixed camera "
                        "(progressive modes: ray tracer, RTAO, VPT)")
    r.add_argument("-o", "--output", default="out/frame.png")
    add_common(r)
    r.set_defaults(fn=cmd_render)

    rp = sub.add_parser("replay", help="run a g.* replay script")
    rp.add_argument("script")
    rp.add_argument("--fps", type=float, default=30.0)
    rp.add_argument("--output-dir", default="out")
    rp.add_argument("--final-frames-only", action="store_true",
                    help="render only each state's final frame")
    add_common(rp)
    rp.set_defaults(fn=cmd_replay)

    v = sub.add_parser(
        "view", help="interactive live-orbit browser viewer (MainApp role)"
    )
    v.add_argument("dataset", help="datasets.json name or dataset file")
    v.add_argument("--renderer", default="Opaque")
    v.add_argument("--port", type=int, default=8123)
    v.add_argument("--accumulate", type=int, default=1)
    v.add_argument("--dataset-set", action="append", metavar="KEY=VALUE")
    add_common(v)
    v.set_defaults(fn=cmd_view)

    pf = sub.add_parser(
        "perf", help="automatic performance measurement (--perf mode)"
    )
    pf.add_argument("dataset")
    pf.add_argument("--oit", action="store_true",
                    help="the OIT sweep matrix (get_test_modes_oit)")
    pf.add_argument("--mode-filter", default=None,
                    help="only states whose name contains this substring")
    pf.add_argument("--csv", default="performance.csv")
    pf.add_argument("--per-frame-csv", default=None)
    pf.add_argument("--flight-seconds", type=float, default=4.0)
    pf.add_argument("--fps", type=float, default=10.0,
                    help="camera-flight sampling rate")
    add_common(pf)
    pf.set_defaults(fn=cmd_perf)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
