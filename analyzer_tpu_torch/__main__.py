"""``python -m analyzer_tpu_torch rate ...``: the port's command line
(:mod:`analyzer_tpu_torch.cli`)."""

if __name__ == "__main__":
    from analyzer_tpu_torch.cli import main

    raise SystemExit(main())
