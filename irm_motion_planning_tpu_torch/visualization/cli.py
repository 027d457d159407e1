"""Visualization CLI — one entry point for the four reference
capabilities (counterpart of irm_motion_planning_tpu/visualization/cli.py).

    python -m irm_motion_planning_tpu_torch.visualization.cli --mode result
    python -m irm_motion_planning_tpu_torch.visualization.cli --mode env --vis-gradient true
    python -m irm_motion_planning_tpu_torch.visualization.cli --mode movement
    python -m irm_motion_planning_tpu_torch.visualization.cli --mode series

Reads the solver's text outputs (trajectory_result.txt /
trajectory_series.txt, as the port's utils/io.py writes them and the
reference's scripts read them, ref: visualization/visualization.py:91,
visualize_series.py:164).  All modes share the solver CLI's parser, so
the hyperparameters cannot diverge; ``--device {cuda,cpu}`` (default
cuda) says where the cost grids are evaluated.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..cli import _bool, build_parser, config_from_args

    p = build_parser()
    p.add_argument("--mode", choices=["result", "env", "movement", "series"],
                   default="result")
    p.add_argument("--input", default="trajectory_result.txt")
    p.add_argument("--series-input", default="trajectory_series.txt")
    p.add_argument("--out", default=None)
    # full reference toggle set (ref: env_vis.py:45-52)
    p.add_argument("--vis-gradient", type=_bool, default=False)
    p.add_argument("--vis-legend", type=_bool, default=True)
    p.add_argument("--vis-sgb", type=_bool, default=True)
    p.add_argument("--vis-sg-robot", type=_bool, default=True)
    p.add_argument("--vis-obstacles", type=_bool, default=False)
    p.add_argument("--vis-straight-line", type=_bool, default=True)
    p.add_argument("--vis-final-ee", type=_bool, default=True)
    p.add_argument("--vis-final-robot", type=_bool, default=False)
    args = p.parse_args(argv)

    from ..device import resolve
    from ..ops.scenario import reference_scenario
    from ..utils import io as iolib
    from . import animate, plots

    device = resolve(args.device if args.device == "cpu" else None)
    cfg = config_from_args(args)
    scn = reference_scenario(cfg, device=device)

    if args.mode == "env":
        out = args.out or "environment.png"
        try:
            traj = iolib.load_trajectory_result(args.input)
        except OSError:
            traj = None
        print(plots.plot_environment(
            cfg, scn, out, args.vis_gradient, traj,
            show_legend=args.vis_legend,
            show_sgb=args.vis_sgb,
            show_sg_robot=args.vis_sg_robot,
            show_obstacles=args.vis_obstacles,
            show_straight_line=args.vis_straight_line,
            show_final_ee=args.vis_final_ee,
            show_final_robot=args.vis_final_robot,
            device=device,
        ))
        return 0

    if args.mode == "result":
        traj = iolib.load_trajectory_result(args.input)
        out = args.out or "result.png"
        print(plots.plot_result(cfg, scn, traj, out, device=device))
        return 0

    if args.mode == "movement":
        traj = iolib.load_trajectory_result(args.input)
        out = args.out or "trajectory_robotmovement.gif"
        print(animate.animate_robot_movement(cfg, scn, traj, out,
                                             device=device))
        return 0

    series = iolib.load_trajectory_series(args.series_input, cfg)
    out = args.out or "trajectory_series.gif"
    print(animate.animate_series(cfg, scn, series, out, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
