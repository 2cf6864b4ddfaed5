"""Offline calibration CLI.

Port of lane_tracker_tpu/calibrate.py, with its subcommands, flags and
``.npz`` keys: the reference's calibration entry points, the
``camera_calibration.py`` script (chessboard photos -> camera matrix +
distortion) and the perspective notebook (4-point warp + metric patch),
producing the native ``calibration.npz`` artifact.  Host numpy/scipy
only; ``camera`` needs cv2 (corner detection) and PIL (reading the
photos) and raises a clear error without them.

Usage:
    # camera intrinsics from chessboard photos
    python -m lane_tracker_tpu_torch.calibrate camera \
        'photos/calibration*.jpg' --nx 9 --ny 6 --out camera.npz

    # full calibration: camera + warp (4 src points, 4 dst points, patch)
    python -m lane_tracker_tpu_torch.calibrate warp camera.npz \
        --src 242,695 564,473 721,473 1064,695 \
        --dst 439,1100 439,380 643,380 643,1100 \
        --image-size 1280x720 --warped-size 1080x1100 \
        --patch-px 196x146 --out calibration.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _parse_pair(s, sep):
    a, b = s.split(sep)
    return (float(a), float(b))


def main(argv=None):
    p = argparse.ArgumentParser(prog="lane_tracker_tpu_torch.calibrate")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("camera", help="chessboard camera calibration")
    pc.add_argument("pattern", help="glob of chessboard photos")
    pc.add_argument("--nx", type=int, default=9)
    pc.add_argument("--ny", type=int, default=6)
    pc.add_argument("--out", required=True)

    pw = sub.add_parser("warp", help="bird's-eye warp calibration")
    pw.add_argument("camera_npz", help="output of the 'camera' step")
    pw.add_argument("--src", nargs=4, required=True,
                    help="4 x,y source points")
    pw.add_argument("--dst", nargs=4, required=True, help="4 x,y dest points")
    pw.add_argument("--image-size", required=True,
                    help="WxH of camera frames")
    pw.add_argument("--warped-size", required=True,
                    help="WxH of bird's-eye view")
    pw.add_argument(
        "--patch-px", required=True,
        help="WxH in warped px of a lane-width x dash-spacing patch",
    )
    pw.add_argument("--patch-m", default="3.66x3.05",
                    help="patch size in meters")
    pw.add_argument("--out", required=True)

    args = p.parse_args(argv)

    if args.cmd == "camera":
        from lane_tracker_tpu_torch.calib.camera import calibrate_from_images

        cam, rms, size = calibrate_from_images(args.pattern, args.nx, args.ny)
        np.savez(
            args.out,
            cam_matrix=cam.cam_matrix,
            dist_coeffs=cam.dist_coeffs,
            image_size=np.asarray(size, np.int64),
            rms=np.float64(rms),
        )
        print(f"camera matrix:\n{cam.cam_matrix}")
        print(f"distortion: {cam.dist_coeffs}")
        print(f"reprojection rms: {rms:.3f} px (frames {size[0]}x{size[1]}) "
              f"-> {args.out}")
        return 0

    from lane_tracker_tpu_torch.calib.io import (
        CameraParams,
        save_calibration_npz,
    )
    from lane_tracker_tpu_torch.calib.perspective import calibrate_warp

    with np.load(args.camera_npz) as z:
        cam = CameraParams(z["cam_matrix"], z["dist_coeffs"])
    src = [_parse_pair(s, ",") for s in args.src]
    dst = [_parse_pair(s, ",") for s in args.dst]
    iw, ih = _parse_pair(args.image_size, "x")
    ww, wh = _parse_pair(args.warped_size, "x")
    pw_, ph = _parse_pair(args.patch_px, "x")
    pmw, pmh = _parse_pair(args.patch_m, "x")
    warp = calibrate_warp(
        src, dst, (int(iw), int(ih)), (int(ww), int(wh)),
        patch_width_px=pw_, patch_height_px=ph,
        patch_width_m=pmw, patch_height_m=pmh,
    )
    save_calibration_npz(args.out, cam, warp)
    print(f"M:\n{warp.M}")
    print(f"mppv={warp.mppv:.6f} m/px, mpph={warp.mpph:.6f} m/px "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
