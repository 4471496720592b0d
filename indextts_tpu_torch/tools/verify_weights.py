"""Command line of the real-weight verification gate
(indextts_tpu_torch/verify.py; counterpart of tools/verify_weights.py).

    python -m indextts_tpu_torch.tools.verify_weights <model_dir> --prompt p.wav \
        [--asr-cmd "..."]
    python -m indextts_tpu_torch.tools.verify_weights --dry-run --prompt p.wav

Converts the ``.pth`` files (strict key mapping via io/checkpoint.py), runs
the reference's 11-case regression battery (tests/regression_test.py:4-42)
on the card, and reports speaker similarity (and WER/CER with an external
ASR) as one JSON line.
"""

from indextts_tpu_torch.verify import main

if __name__ == "__main__":
    main()
