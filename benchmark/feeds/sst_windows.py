"""The program's on-device generator of SST windows
(``data/sst_device.py:DeviceZoneWindows``) over the mix's corpus; the
reference's copy of its draws is ``reference/sources/sst_windows.py``."""


def program_generator(job, made):
    from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows

    c, mix = job.config, job.traffic
    return DeviceZoneWindows(made.cpu().numpy(), c["nt_cond"], c["nt_cond"] + c["nt_pred"],
                             mix["windows_per_zone"], mix["first"], device=job.device)
