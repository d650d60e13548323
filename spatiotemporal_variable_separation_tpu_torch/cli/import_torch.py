"""Convert a trained reference (PyTorch) experiment dir into one of the port's.

The port's counterpart of the JAX package's ``cli/import_torch.py``, with the
same flags.  A reference ``xp_dir`` (``params.json`` and the pickled
``ov_Es/ov_Et/t_resnet/decoder.pt``, ``var_sep/utils/helper.py:22-33``)
becomes a directory that every eval CLI and ``Forecaster`` read:

    varsep-torch-import-torch --ref_xp_dir REF_XP --xp_dir NEW_XP \\
        [--epoch N] [--reference_path /path/to/reference/repo]

``--reference_path``: a directory under which ``import var_sep`` works, where
the pickles name the reference's classes.

The conversion runs on the host and runs no model: the port's model is built
with ``device="cpu"``, explicitly.  Whatever loads the result then runs on
the card (``core/device.py:resolve_device``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="varsep-torch-import-torch", description=__doc__)
    p.add_argument("--ref_xp_dir", type=str, metavar="DIR", required=True,
                   help="reference experiment directory to import")
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True,
                   help="output experiment directory (created)")
    p.add_argument("--epoch", type=int, metavar="N", default=None,
                   help="import the epoch-N snapshot (ov_Es_N.pt ...) "
                        "instead of the final one")
    p.add_argument("--reference_path", type=str, metavar="DIR", default=None,
                   help="path under which `import var_sep` resolves")
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.utils.transplant import (
        import_reference_checkpoint,
    )

    import_reference_checkpoint(args.ref_xp_dir, args.xp_dir, epoch=args.epoch,
                                reference_root=args.reference_path)


if __name__ == "__main__":
    main()
