#!/usr/bin/env python3
"""Time the port's host decode: `BatchPipeline` batches of a Crowd-11-shaped mp4 dataset.

    python3 tools/time_ingest_torch.py [--scenes 16] [--workers 1,2,4,8,16]

Writes `--scenes` × 3 clips of 48 frames at 240×320 (`chip_smoke.py` phase
21's geometry, 11 classes) with `data.generate_synthetic_dataset`, then
times one pass of `BatchPipeline(SampleSpec(20, (256, 256)), 16,
shuffle=False).batches(0)` (every clip decoded once, no padding when the
clip count is a multiple of 16) for each thread-pool size, first with cv2's
own thread count as it is and then with `cv2.setNumThreads(1)`, and the
two-stream gray-pair staging at the largest pool size; then, below the
pipeline, a plain read of every frame of every clip by `cv2.VideoCapture`
in the same thread pools, with FFmpeg's own decode threads as cv2 opens
them and with one (`CAP_PROP_N_THREADS`): how the codec's threads and the
pool's share the cores.  Host only: no card is used, so the numbers are
those of the machine it runs on, printed with its CPU count and cv2
version.  Prints a line per setting and one JSON line last.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=16)
    parser.add_argument("--workers", default="1,2,4,8,16")
    args = parser.parse_args()
    import cv2

    from crowded_scenes_ensemble_classification_tpu_torch import data

    workers = [int(w) for w in args.workers.split(",")]
    default_threads = cv2.getNumThreads()
    print(f"os.cpu_count() {os.cpu_count()}, cv2 {cv2.__version__}, cv2 threads {default_threads}")
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data.generate_synthetic_dataset(tmp, num_scenes=args.scenes, clips_per_scene=3, num_classes=11,
                                        num_frames=48, hw=(240, 320), write_flow=False, as_videos=True)
        table = data.build_clip_table(tmp).rename({"label": "class"})
        print(f"{len(table)} clips written in {time.perf_counter() - t0:.1f} s")

        def timed(spec, num_workers) -> float:
            pipe = data.BatchPipeline(table, spec, 16, shuffle=False, num_workers=num_workers)
            t = time.perf_counter()
            for _ in pipe.batches(0):
                pass
            return len(table) / (time.perf_counter() - t)

        rgb = data.SampleSpec(20, (256, 256))
        timed(rgb, workers[-1])  # warm-up: page cache, codec start-up
        for cv2_threads in (default_threads, 1):
            cv2.setNumThreads(cv2_threads)
            for w in workers:
                cps = timed(rgb, w)
                records.append({"staging": "rgb", "cv2_threads": cv2_threads, "workers": w, "clips_per_s": cps})
                print(f"rgb, cv2 threads {cv2_threads}, {w} decode threads: {cps:.2f} clips/s")
            pairs = data.SampleSpec(20, (256, 256), two_stream=True, flow_precomputed=False)
            cps = timed(pairs, workers[-1])
            records.append({"staging": "gray_pairs", "cv2_threads": cv2_threads, "workers": workers[-1],
                            "clips_per_s": cps})
            print(f"rgb + gray pairs, cv2 threads {cv2_threads}, {workers[-1]} decode threads: {cps:.2f} clips/s")
        cv2.setNumThreads(default_threads)

        def read_all(path, codec_threads) -> int:
            params = [cv2.CAP_PROP_N_THREADS, codec_threads] if codec_threads else []
            cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG, params)
            n = 0
            while cap.grab():
                n += cap.retrieve()[0]
            cap.release()
            return n

        paths = list(table["rgbclips_path"])
        for codec_threads in (0, 1):
            for w in workers:
                with cf.ThreadPoolExecutor(max_workers=w) as pool:
                    t = time.perf_counter()
                    frames = sum(pool.map(lambda p: read_all(p, codec_threads), paths))
                    cps = len(paths) / (time.perf_counter() - t)
                if frames != 48 * len(paths):
                    raise RuntimeError(f"read {frames} frames, not {48 * len(paths)}")
                records.append({"staging": "read_all_frames", "codec_threads": codec_threads or "default",
                                "workers": w, "clips_per_s": cps})
                print(f"cv2.VideoCapture read of all 48 frames, FFmpeg threads {codec_threads or 'default'}, "
                      f"{w} threads: {cps:.2f} clips/s")
    print(json.dumps({"cpu_count": os.cpu_count(), "cv2": cv2.__version__, "clips": len(table), "runs": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
