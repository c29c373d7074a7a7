"""Command line of the port — the counterpart of csinn2_tpu/__main__.py.

    python -m csinn2_tpu_torch [--whereis] [--ops] [--backend [--device cpu]]
    python -m csinn2_tpu_torch convert <gguf-or-hf-dir> <out_dir> [--mode q8_0]
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "convert":
        from csinn2_tpu_torch.llm.convert import main as convert_main
        return convert_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m csinn2_tpu_torch")
    ap.add_argument("--whereis", action="store_true", help="print install path")
    ap.add_argument("--ops", action="store_true", help="list registered ops")
    ap.add_argument("--backend", action="store_true",
                    help="print the torch / CUDA versions and the card")
    ap.add_argument("--device", default="cuda",
                    help="device --backend reports (cuda, the default, or cpu)")
    args = ap.parse_args(argv)

    import csinn2_tpu_torch
    from csinn2_tpu_torch.ops.registry import registry
    root = os.path.dirname(os.path.abspath(csinn2_tpu_torch.__file__))
    if args.whereis:
        print(root)
        return 0
    if args.ops:
        for op in registry.ops():
            print(op)
        return 0
    if args.backend:
        from csinn2_tpu_torch.utils.platform import backend_summary
        print(backend_summary(args.device))
        return 0
    print(f"csinn2_tpu_torch {csinn2_tpu_torch.__version__}")
    print(f"install:    {root}")
    print(f"ops:        {len(registry.ops())} registered")
    print("usage:      python -m csinn2_tpu_torch [--whereis|--ops|--backend] | "
          "convert <gguf-or-hf-dir> <out_dir> [--mode MODE]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
