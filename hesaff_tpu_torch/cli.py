"""Command-line interface of the PyTorch port.

``python -m hesaff_tpu_torch.cli extract image.ppm`` reproduces the
reference binary's contract: writes ``<image>.hesaff.sift`` and prints
the detection summary line.  The subcommands, arguments, defaults,
output lines and exit codes are the JAX package's ``hesaff_tpu.cli``
ones for ``extract``, ``match``, ``eval``, ``retrieve``, ``sfm`` and
``fleet``; where that CLI takes ``--platform``, this one takes
``--device``: the GPU by default, ``cpu`` on request.
"""

from __future__ import annotations

import argparse
import sys
import time

_DEVICE_HELP = 'where to run: the GPU by default, "cpu" on request'


def _cmd_extract(args) -> int:
    import dataclasses

    from hesaff_tpu_torch.config import FAST_CONFIG, HesaffConfig
    from hesaff_tpu_torch.pipeline import extract
    from hesaff_tpu_torch.sift_io import load_image_gray, write_sift_file

    # the reference driver plumbs threshold/max_iter/patch/mrSize;
    # upscale is a pyramid parameter (default off)
    base = FAST_CONFIG if args.fast else HesaffConfig()
    cfg = dataclasses.replace(
        base,
        threshold=args.threshold,
        max_iterations=(base.max_iterations if args.fast
                        else args.max_iter),
        patch_size=args.patch_size,
        mr_size=args.mr_size,
        upscale_input=args.upscale,
    )
    gray = load_image_gray(args.image)
    t0 = time.perf_counter()
    feats, stats = extract(gray, cfg, device=args.device, return_stats=True)
    elapsed = time.perf_counter() - t0
    out = args.output or (args.image + ".hesaff.sift")
    write_sift_file(
        out, feats.x, feats.y, feats.s,
        feats.a11, feats.a12, feats.a21, feats.a22,
        feats.desc, cfg.mr_size,
    )
    # summary line format follows the reference driver
    print(
        f"Detected {stats.num_keypoints} keypoints and {stats.num_described} "
        f"affine shapes in {elapsed:.6g} sec."
    )
    if stats.candidate_overflow or stats.bucket_overflow:
        print(
            f"warning: capacity overflow (candidates={stats.candidate_overflow}"
            f", buckets={stats.bucket_overflow})",
            file=sys.stderr,
        )
    return 0


def _cmd_match(args) -> int:
    import numpy as np

    from hesaff_tpu_torch.config import HesaffConfig
    from hesaff_tpu_torch.match import match_descriptors
    from hesaff_tpu_torch.pipeline import extract
    from hesaff_tpu_torch.ransac import ransac_fundamental, ransac_homography
    from hesaff_tpu_torch.sift_io import load_image_gray

    cfg = HesaffConfig()
    f1 = extract(load_image_gray(args.image1), cfg, device=args.device)
    f2 = extract(load_image_gray(args.image2), cfg, device=args.device)
    i1, i2 = match_descriptors(f1.desc, f2.desc, ratio=args.ratio,
                               device=args.device)
    print(f"{f1.n} x {f2.n} features -> {len(i1)} tentative matches")
    if len(i1) >= 8 and args.verify != "none":
        p1 = np.stack([f1.x[i1], f1.y[i1]], 1)
        p2 = np.stack([f2.x[i2], f2.y[i2]], 1)
        ransac = (ransac_homography if args.verify == "homography"
                  else ransac_fundamental)
        res = ransac(p1, p2, device=args.device)
        print(f"RANSAC ({args.verify}): {int(res.num_inliers)} inliers")
    if args.output:
        np.savez(args.output, idx1=i1, idx2=i2)
    return 0


def _cmd_eval(args) -> int:
    """Oxford-protocol repeatability between two images + homography file."""
    import numpy as np

    from hesaff_tpu_torch.config import HesaffConfig
    from hesaff_tpu_torch.evaluate import features_to_ellipses, repeatability
    from hesaff_tpu_torch.pipeline import extract
    from hesaff_tpu_torch.sift_io import load_image_gray

    cfg = HesaffConfig()
    img1 = load_image_gray(args.image1)
    img2 = load_image_gray(args.image2)
    H = (np.loadtxt(args.homography) if args.homography
         else np.eye(3))
    f1 = extract(img1, cfg, device=args.device)
    f2 = extract(img2, cfg, device=args.device)
    r = repeatability(
        features_to_ellipses(f1, cfg.mr_size),
        features_to_ellipses(f2, cfg.mr_size),
        H, img2.shape, f1.desc, f2.desc,
        shape1=img1.shape, device=args.device,
    )
    print(f"n1={r.n1} n2={r.n2} correspondences={r.num_correspondences} "
          f"repeatability={r.repeatability:.3f} "
          f"matches={r.num_matches} matching_score={r.matching_score:.3f}")
    return 0


def _cmd_retrieve(args) -> int:
    """Rank a feature database (a directory of .npz files with a `desc`
    array) for a query image by descriptor kNN voting."""
    import glob
    import os

    import numpy as np

    from hesaff_tpu_torch.config import HesaffConfig
    from hesaff_tpu_torch.pipeline import extract
    from hesaff_tpu_torch.retrieval import build_index, rank_images
    from hesaff_tpu_torch.sift_io import load_image_gray

    paths = sorted(glob.glob(os.path.join(args.db, "*.npz")))
    if not paths:
        print(f"no .npz feature files in {args.db}", file=sys.stderr)
        return 1
    names, descs = [], []
    for p in paths:
        d = np.load(p)
        if "desc" not in d.files or d["desc"].size == 0:
            continue
        names.append(os.path.splitext(os.path.basename(p))[0])
        descs.append(d["desc"])
    if not names:
        print(f"no usable descriptors in {args.db} "
              f"({len(paths)} .npz files, all empty)", file=sys.stderr)
        return 1
    index = build_index(descs)
    feats = extract(load_image_gray(args.image), HesaffConfig(),
                    device=args.device)
    ranked = rank_images(index, feats.desc, ratio=args.ratio,
                         top_k=min(args.topk, len(names)),
                         device=args.device)
    for img_id, votes in ranked:
        print(f"{names[img_id]} {votes}")
    return 0


def _cmd_fleet(args) -> int:
    """Checkpointed extraction over an image list (.npz per image);
    exits 1 when any image failed."""
    from hesaff_tpu_torch.utils.fleet import extract_fleet

    cursor = extract_fleet(args.images, args.out_dir,
                           batch_size=args.batch_size, device=args.device)
    print(f"done={len(cursor['done'])} failed={len(cursor['failed'])}")
    return 0 if not cursor["failed"] else 1


def _cmd_sfm(args) -> int:
    """Incremental SfM over an ordered frame sequence: sequential
    matching (sfm.SequentialMatcher: each frame extracted on the grouped
    path, matched with the `--window` frames before it and RANSAC
    verified), union-find tracks, incremental registration and Schur
    BA, then a poses / points npz and a reprojection report."""
    import glob
    import os

    import numpy as np

    from hesaff_tpu_torch.config import HesaffConfig
    from hesaff_tpu_torch.sfm import (SequentialMatcher, build_tracks,
                                      incremental_sfm)
    from hesaff_tpu_torch.sift_io import load_image_gray

    paths = list(args.frames)
    if len(paths) == 1 and os.path.isdir(paths[0]):
        exts = ("*.png", "*.ppm", "*.pgm", "*.jpg", "*.jpeg", "*.pnm")
        paths = sorted(p for e in exts
                       for p in glob.glob(os.path.join(paths[0], e)))
    if len(paths) < 2:
        print("sfm needs >= 2 frames (got "
              f"{len(paths)})", file=sys.stderr)
        return 1

    # each frame matched with the `window` frames before it, every pair
    # verified by F-RANSAC (1,024 hypotheses, Sampson threshold 3 px^2)
    matcher = SequentialMatcher(HesaffConfig(), window=args.window,
                                ratio=args.ratio, hypotheses=1024,
                                sampson_px=3.0 ** 0.5, device=args.device)
    feats, shape0, matches = [], None, {}
    for p in paths:
        img = load_image_gray(p)
        shape0 = shape0 or img.shape
        got = matcher.push(img)
        if got.overflow:
            print(f"warning: {p}: capacity overflow ({got.overflow} "
                  "keypoints dropped)", file=sys.stderr)
        feats.append(got.features)
        for pm in got.pairs:
            if len(pm.idx_older) >= 16 and pm.inliers.sum() >= 16:
                matches[(pm.older, pm.newer)] = (pm.idx_older[pm.inliers],
                                                 pm.idx_newer[pm.inliers])
    H0, W0 = shape0
    focal = args.focal or 1.2 * max(H0, W0)
    K = np.array([[focal, 0.0, W0 / 2.0],
                  [0.0, focal, H0 / 2.0],
                  [0.0, 0.0, 1.0]])

    kps = [np.stack([f.x, f.y], 1) for f in feats]
    if (0, 1) not in matches:
        print("frames 0 and 1 share too few verified matches to seed",
              file=sys.stderr)
        return 1
    tracks = build_tracks(kps, matches)
    rec = incremental_sfm(tracks, K, ba_every=args.ba_every,
                          device=args.device)
    out = args.output or "recon.npz"
    np.savez(out, cam_rvec=rec.cam_rvec, cam_tvec=rec.cam_tvec,
             points=rec.points, track_ids=rec.track_ids,
             frame_ids=rec.frame_ids, rmse=rec.rmse, K=K,
             frames=np.array(paths))
    print(f"frames={len(paths)} registered={len(rec.cam_rvec)} "
          f"points={len(rec.points)} tracks={len(tracks)} "
          f"reproj_rmse={rec.rmse:.5f} -> {out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hesaff_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("extract", help="detect + describe one image")
    pe.add_argument("image")
    pe.add_argument("-o", "--output", default=None)
    pe.add_argument("--threshold", type=float, default=16.0 / 3.0)
    pe.add_argument("--max-iter", type=int, default=16)
    pe.add_argument("--patch-size", type=int, default=41)
    pe.add_argument("--mr-size", type=float, default=3.0 * 3.0**0.5)
    pe.add_argument("--upscale", action="store_true",
                    help="2x upscale the input before the pyramid")
    pe.add_argument("--fast", action="store_true",
                    help="documented fast mode (config.FAST_CONFIG; "
                         "accuracy delta in OXFORD.md)")
    pe.add_argument("--device", default=None, help=_DEVICE_HELP)
    pe.set_defaults(fn=_cmd_extract)

    pm = sub.add_parser("match", help="match two images (+RANSAC verify)")
    pm.add_argument("image1")
    pm.add_argument("image2")
    pm.add_argument("-o", "--output", default=None)
    pm.add_argument("--ratio", type=float, default=0.8)
    pm.add_argument("--verify", default="fundamental",
                    choices=["none", "homography", "fundamental"])
    pm.add_argument("--device", default=None, help=_DEVICE_HELP)
    pm.set_defaults(fn=_cmd_match)

    pv = sub.add_parser("eval",
                        help="Oxford repeatability of an image pair")
    pv.add_argument("image1")
    pv.add_argument("image2")
    pv.add_argument("--homography", default=None,
                    help="3x3 homography text file (VGG H1to2p format)")
    pv.add_argument("--device", default=None, help=_DEVICE_HELP)
    pv.set_defaults(fn=_cmd_eval)

    pr = sub.add_parser("retrieve",
                        help="rank a feature database for a query image")
    pr.add_argument("image")
    pr.add_argument("--db", required=True,
                    help="directory of .npz features (each with `desc`)")
    pr.add_argument("--topk", type=int, default=10)
    pr.add_argument("--ratio", type=float, default=0.9)
    pr.add_argument("--device", default=None, help=_DEVICE_HELP)
    pr.set_defaults(fn=_cmd_retrieve)

    ps = sub.add_parser("sfm",
                        help="incremental SfM over an ordered frame "
                             "sequence -> poses/points npz")
    ps.add_argument("frames", nargs="+",
                    help="frame images in order, or one directory")
    ps.add_argument("-o", "--output", default=None,
                    help="output npz (default recon.npz)")
    ps.add_argument("--focal", type=float, default=None,
                    help="focal length in px (default 1.2*max(H,W))")
    ps.add_argument("--ratio", type=float, default=0.8)
    ps.add_argument("--window", type=int, default=5,
                    help="match frame i with i+1..i+window")
    ps.add_argument("--ba-every", type=int, default=5)
    ps.add_argument("--device", default=None, help=_DEVICE_HELP)
    ps.set_defaults(fn=_cmd_sfm)

    pf = sub.add_parser("fleet",
                        help="checkpointed batch extraction over images")
    pf.add_argument("images", nargs="+")
    pf.add_argument("--out-dir", required=True)
    pf.add_argument("--batch-size", type=int, default=8)
    pf.add_argument("--device", default=None, help=_DEVICE_HELP)
    pf.set_defaults(fn=_cmd_fleet)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
