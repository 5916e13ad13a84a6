"""T2I training: ``cli/train_lfm`` under its reference name (one loop
serves every mode, the config's ``train.mode``; the reference splits them
into ``train_lfm.py`` and ``train_lfm_t2i.py``).

    python -m uspace_tpu_torch.cli.train_lfm_t2i --config synthetic_t2i_e2e \\
        --workdir t2i_toy
"""

from .train_lfm import main, run

__all__ = ["main", "run"]

if __name__ == "__main__":
    main()
