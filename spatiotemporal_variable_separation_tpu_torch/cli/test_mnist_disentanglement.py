"""Moving MNIST content-swap eval CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.test_mnist_disentanglement \\
        --xp_dir X --data_dir D --nt_pred 10

The port's counterpart of the JAX package's
``cli/test_mnist_disentanglement.py`` (reference ``python -m
var_sep.test.mnist.test_disentanglement``): the flags, print and
``evals.json`` record of ``cli.test_mnist``, under ``mnist_swap_t<nt_pred>``."""


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.test_mnist import run
    from spatiotemporal_variable_separation_tpu_torch.eval.mnist_swap import evaluate

    return run(evaluate, "mnist_swap", "varsep Moving MNIST content-swap testing (PyTorch)",
               argv)


if __name__ == "__main__":
    main()
