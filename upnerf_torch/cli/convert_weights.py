"""Weight converters (upnerf/cli/convert_weights.py): torch checkpoints ->
the assets and run directories the port reads, and back.

    python -m upnerf_torch.cli.convert_weights dino <ckpt.pth> <out.npz>
    python -m upnerf_torch.cli.convert_weights dpt <ckpt.pt> <out.npz>
    python -m upnerf_torch.cli.convert_weights lpips <out.npz>   # needs the `lpips` package
    python -m upnerf_torch.cli.convert_weights model <ref.ckpt> <result_dir> \\
        [--config cfg.yaml]   # a trained reference run -> a run directory of the port
    python -m upnerf_torch.cli.convert_weights export <result_dir> <out.ckpt> \\
        [--ckpt last|best]    # a run directory of the port -> a reference Lightning checkpoint

`dino` / `dpt` write the npz layout both packages' extractors read
(features/convert.py); `lpips` the AlexNet LPIPS asset (evaluate/lpips.py).
The port's checkpoints are reference checkpoints, so `model` checks one (its
hyper_parameters or --config, the scene's train-image count, the model
structure) and copies it into `<result_dir>/{config.yaml, ckpts/}`, which
cli.render_video --result_dir reads and whose checkpoint cli.tto / cli.eval
take; `export` writes a run's last or best checkpoint in the reference's
Lightning layout (utils/weights.py). Runs on the CPU.
"""

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["dino", "dpt", "lpips", "model", "export"])
    parser.add_argument("args", nargs="+")
    parser.add_argument("--config", default=None,
                        help="model: framework config yaml (defaults to the checkpoint's own hyper_parameters)")
    parser.add_argument("--ckpt", default="last", choices=["last", "best"],
                        help="export: which checkpoint of the run to export")
    a = parser.parse_args(argv)
    n_required = {"dino": 2, "dpt": 2, "lpips": 1, "model": 2, "export": 2}[a.kind]
    if len(a.args) != n_required:
        parser.error(f"convert_weights {a.kind} takes exactly {n_required} positional argument(s) after the kind"
                     f" (got {len(a.args)}) — see the module docstring for usage")
    if a.kind == "model":
        from upnerf_torch.utils.weights import convert_reference_run

        convert_reference_run(a.args[0], a.args[1], a.config)
        return
    if a.kind == "export":
        from upnerf_torch.utils.weights import export_run

        export_run(a.args[0], a.args[1], ckpt=a.ckpt)
        return
    if a.kind == "dino":
        from upnerf_torch.features.convert import convert_dino_vit

        convert_dino_vit(a.args[0], a.args[1])
    elif a.kind == "dpt":
        from upnerf_torch.features.convert import convert_dpt

        convert_dpt(a.args[0], a.args[1])
    else:
        from upnerf_torch.evaluate.lpips import convert_from_torch

        convert_from_torch(a.args[0])
    print("converted.")


if __name__ == "__main__":
    main()
