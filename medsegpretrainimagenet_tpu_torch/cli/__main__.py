"""``python -m medsegpretrainimagenet_tpu_torch.cli config.yaml
[--continued] [--device cpu]``: the port's experiment CLI."""
from .experiment import main

if __name__ == "__main__":
    main()
