"""Training data: Moving MNIST on the host (``moving_mnist``) and on the card
(``mnist_device``), the host pipeline (``loader``) and the dataset dispatch
(``registry``).  Importing this package imports none of them."""
