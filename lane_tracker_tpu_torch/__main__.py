from lane_tracker_tpu_torch.process_video import run

if __name__ == "__main__":
    raise SystemExit(run())
