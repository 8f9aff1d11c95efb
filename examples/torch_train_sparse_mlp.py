"""End-to-end example #1 on the PyTorch port: the paper's own experiment
(counterpart of ``examples/train_sparse_mlp.py``).

Trains the (800, 100, 100, 100, 10) MLP of paper Table II at several
densities with all three pattern methods and prints the comparison —
a few hundred optimizer steps per configuration.

    PYTHONPATH=src python examples/torch_train_sparse_mlp.py \
        [--epochs 8 --rows 3 --device cpu]

The MLPs keep the JAX example's configs, which train in ``mode="mask"``: a
dense ``torch.matmul`` under a fixed 0/1 mask, so this example runs none of
the hand-written kernels. ``chip_smoke.py`` phase 3e trains the paper MLP
in the block modes, on the small-block junction kernels.
"""
import argparse

from repro_torch.configs.paper_mlp import MNIST_4J, rho_from_dout
from repro_torch.data import synthetic_mnist
from repro_torch.nn.common import resolve_device
from repro_torch.nn.mlp import MLPConfig, SparseMLP, train_mlp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--rows", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    data = synthetic_mnist(n_train=6000, n_test=1500)
    ladder = [(40, 40, 40, 10), (10, 10, 10, 10), (1, 2, 2, 10)]
    print(f"{'d_out':>18s} {'rho%':>6s} {'clashfree':>10s} "
          f"{'structured':>10s} {'random':>10s}")
    for d_out in ladder[:args.rows]:
        rho = rho_from_dout(MNIST_4J, d_out)
        accs = {}
        for method in ("clashfree", "structured", "random"):
            cfg = MLPConfig(n_net=MNIST_4J, rho=rho, method=method)
            model = SparseMLP(cfg, device=device)
            _, acc = train_mlp(model, data, epochs=args.epochs)
            accs[method] = acc
        rho_net = SparseMLP(MLPConfig(n_net=MNIST_4J, rho=rho),
                            device=device).density()
        print(f"{str(d_out):>18s} {100 * rho_net:6.1f} "
              f"{accs['clashfree']:10.3f} {accs['structured']:10.3f} "
              f"{accs['random']:10.3f}")


if __name__ == "__main__":
    main()
