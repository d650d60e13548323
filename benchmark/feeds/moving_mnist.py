"""The program's on-device generator of Moving MNIST batches
(``data/mnist_device.py:DeviceMovingMNIST``) over the mix's digits; the
reference's copy of its draws is ``reference/sources/moving_mnist.py``."""


def program_generator(job, made):
    from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST

    c, mix = job.config, job.traffic
    return DeviceMovingMNIST(made.cpu().numpy(), c["nt_cond"], c["nt_cond"] + c["nt_pred"],
                             mix["num_digits"], max_speed=mix["max_speed"], device=job.device)
