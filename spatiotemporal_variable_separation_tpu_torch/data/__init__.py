"""Training data: Moving MNIST on the host (``moving_mnist``) and on the card
(``mnist_device``), WaveEq simulated and loaded (``wave_eq``) and its windows
gathered on the card (``wave_device``), 3D Chairs renders (``chairs``), TaxiBJ
(``taxibj``) and SST (``sst``), the stand-in corpora (``synthetic_corpora``),
their windows gathered on the card (``chairs_device``, ``taxibj_device``,
``sst_device``), the host pipeline (``loader``) and the dataset dispatch
(``registry``).  Importing this package imports none of them."""
