"""Quickstart on the PyTorch port: the paper's technique in 30 lines
(counterpart of ``examples/quickstart.py``).

Builds a pre-defined sparse junction (clash-free pattern), shows its
storage/compute savings, and trains the paper's (800, 100, 10) MLP at
rho=21% on the synthetic MNIST stand-in for a couple of epochs.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The MLP keeps the JAX example's config, which trains in ``mode="mask"``: a
dense ``torch.matmul`` under a fixed 0/1 mask, so this example runs none of
the hand-written kernels. ``chip_smoke.py`` phase 3e trains the paper MLP
in the block modes, on the small-block junction kernels.
"""
import argparse

from repro_torch.configs.paper_mlp import MNIST_2J, rho_from_dout
from repro_torch.core.sparsity import make_pattern, schedule_is_clash_free
from repro_torch.core.storage import storage_cost
from repro_torch.data import synthetic_mnist
from repro_torch.nn.common import resolve_device
from repro_torch.nn.mlp import MLPConfig, SparseMLP, train_mlp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. a clash-free pre-defined sparse pattern (paper §III-C, type 1)
    pat = make_pattern(n_left=800, n_right=100, rho=0.2,
                       method="clashfree", seed=0)
    print(f"junction 800x100 @ rho={pat.density:.0%}: "
          f"{pat.n_edges} edges, d_in={pat.d_in}")
    sched = pat.meta["sched"]
    print("clash-free schedule verified:",
          schedule_is_clash_free(sched, 800 // pat.meta["z"]))

    # 2. the hardware storage saving (paper Table I)
    fc = storage_cost(MNIST_2J)
    sp = storage_cost(MNIST_2J, d_in=[160, 100])
    print(f"storage words: FC={fc.total}  sparse={sp.total} "
          f"({fc.total / sp.total:.1f}x smaller)")

    # 3. train the paper's MLP with that sparsity
    data = synthetic_mnist(n_train=3000, n_test=800)
    cfg = MLPConfig(n_net=MNIST_2J,
                    rho=rho_from_dout(MNIST_2J, (20, 10)),
                    method="clashfree")
    model = SparseMLP(cfg, device=device)
    print(f"training sparse MLP: |W|={model.n_weights()} "
          f"(density {model.density():.0%}) ...")
    _, acc = train_mlp(model, data, epochs=4)
    print(f"test accuracy: {acc:.3f}")


if __name__ == "__main__":
    main()
