"""One module per entry kind, found by the name a traffic file gives.

An entry module defines:

- `COMPARED`: the names of the numbers that decide `correct`, each with a
  limit in the cell's file;
- `CAPTURE`: {"counts": path, "distances": path}, the dotted paths of the
  attributes through which the timed path calls its sampler and its
  per-resample distance; in checked calls the harness keeps what they
  return;
- `Session(config, traffic, seed, devices)`: the user's set-up from the
  seed, with `call(key) -> (sorted distances, quantiles)`, one interval as
  the user asks for it, and `release() -> inputs`, which drops the
  program's state and returns what the check needs;
- `readings(config, traffic, inputs, samples, device, control=False)`: the
  numbers compared, by name, and with `control` the control's as well;
  `samples` are the checked calls, (call index, (captured tensors,
  distances, quantiles));
- `verify(config, traffic, inputs, samples, limits, device)`: the numbers
  compared, each as (name, value, limit).
"""
