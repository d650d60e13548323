"""One file a data source, named as a traffic mix's ``source`` names it:
``make(mix, seed, device)``, what the mix draws its batches from, made from
the seed, and ``draw(gen, made, mix, batch, seq_len)``, one batch of
(batch, seq_len, H, W, C) frames drawn with the generator ``gen`` in the
order and with the calls the program's generator makes them
(``feeds/<source>.py`` builds that generator)."""
