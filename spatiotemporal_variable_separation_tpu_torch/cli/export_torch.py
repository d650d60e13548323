"""Convert an experiment dir of the port into a reference (PyTorch) one.

The port's counterpart of the JAX package's ``cli/export_torch.py``, with the
same flags, and the reverse of ``cli.import_torch``: a model trained with the
port becomes the reference's experiment layout (``params.json`` and the
pickled ``ov_Es/ov_Et/t_resnet/decoder.pt``, ``var_sep/utils/helper.py:22-33``),
which the reference's own eval scripts (``var_sep/test/*/test*.py``) score.

    varsep-torch-export-torch --xp_dir PORT_XP --ref_xp_dir TORCH_XP \\
        [--name CKPT] [--reference_path /path/to/reference/repo]

``--reference_path``: a directory under which ``import var_sep`` works; the
pickles are the reference's own classes, built by its factory
(``var_sep/networks/factory.py``).

The conversion runs on the host and runs no model: the checkpoint is loaded
with ``device="cpu"``, explicitly.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="varsep-torch-export-torch", description=__doc__)
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True,
                   help="experiment directory of the port to export")
    p.add_argument("--ref_xp_dir", type=str, metavar="DIR", required=True,
                   help="output reference-layout experiment dir (created)")
    p.add_argument("--name", type=str, metavar="CKPT", default=None,
                   help="checkpoint to export (e.g. 'final' or an epoch "
                        "number; default: the newest)")
    p.add_argument("--reference_path", type=str, metavar="DIR", default=None,
                   help="path under which `import var_sep` resolves")
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.utils.export import (
        export_reference_checkpoint,
    )

    export_reference_checkpoint(args.xp_dir, args.ref_xp_dir, name=args.name,
                                reference_root=args.reference_path)


if __name__ == "__main__":
    main()
